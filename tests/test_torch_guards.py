"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points run on the card unless the caller asks for the
CPU, and the kernel wrapper launches nothing for CPU tensors."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.kernels import fdp_gemm as tk  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.models import init, transformer as TT  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops, "
            "repro_torch.models, repro_torch.models.moe, repro_torch.launch.serve, "
            "repro_torch.configs, repro_torch.core.qformat, repro_torch.train, "
            "repro_torch.train.optimizer, repro_torch.train.loop, "
            "repro_torch.checkpoint.store, repro_torch.data.synthetic, "
            "repro_torch.launch.train, repro_torch.numerics, repro_torch.numerics.plan, "
            "repro_torch.core.energy, repro_torch.core.metrics, repro_torch.core.generator\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is legal here")
    cfg = get_config("paper-mlp").reduced()
    params = init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.serve(cfg, params, torch.zeros(1, 2, dtype=torch.long), 1, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLT.main(["--arch", "paper-mlp", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, None, None, None, "unused")


def test_serve_refuses_params_on_another_device():
    cfg = get_config("paper-mlp").reduced()
    params = init(cfg, device="cpu")
    with pytest.raises(ValueError, match="params are on"):
        TS.serve(cfg, params, torch.zeros(1, 2, dtype=torch.long), 1, device="meta")


def test_other_families_name_their_roadmap_item():
    for arch, item in (("mamba2-1.3b", "item 13"), ("whisper-large-v3", "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            init(get_config(arch).reduced(), device="cpu")


def test_cpu_tensors_launch_no_kernel():
    before = tk.fdp_gemm.launches
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 16)).astype(np.float32))
    b = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 4)).astype(np.float32))
    with TD.use_policy(TS.FDP91_KERNEL):
        out = TD.gemm(a, b, site="probe")
    assert out.shape == (2, 3, 4)
    assert tk.fdp_gemm.launches == before
    if not torch.cuda.is_available():
        assert before == 0


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    runs = []
    if not torch.cuda.is_available():
        runs.append(ROOT)                      # no card
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(tmp_path)                      # chip_smoke.py alone
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in runs:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, cwd
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout

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
            "repro_torch.models, repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.launch.serve, "
            "repro_torch.configs, repro_torch.core.qformat, repro_torch.train, "
            "repro_torch.train.optimizer, repro_torch.train.loop, "
            "repro_torch.checkpoint.store, repro_torch.data.synthetic, "
            "repro_torch.launch.train, repro_torch.numerics, repro_torch.numerics.plan, "
            "repro_torch.core.energy, repro_torch.core.metrics, repro_torch.core.generator, "
            "repro_torch.workloads, repro_torch.workloads.__main__, "
            "repro_torch.data.conditioned, repro_torch.obs, repro_torch.obs.export, "
            "repro_torch.obs.__main__, repro_torch.launch.batching, repro_torch.obs.monitor, "
            "repro_torch.serving, repro_torch.serving.__main__, repro_torch.launch.mesh, "
            "repro_torch.launch.sharding, repro_torch.parallel.collectives, "
            "repro_torch.parallel.axes, repro_torch.workloads.mesh\n"
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


def test_continuous_engine_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is legal here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main(["--arch", "paper-mlp", "--reduced", "--engine", "continuous"])


def test_routed_serving_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is legal here")
    from repro_torch.serving.__main__ import main as serving_main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_main(["--arch", "paper-mlp", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main(["--arch", "paper-mlp", "--reduced", "--engine", "routed"])


def test_graph_engines_refuse_cpu_parameters():
    from repro_torch.serving import Bucket, BucketedEnginePool, ScoreEngine
    cfg = get_config("paper-mlp").reduced()
    params = init(cfg, device="cpu")
    with pytest.raises(ValueError, match="graph=True needs the parameters on a CUDA"):
        BucketedEnginePool(cfg, params, "2x16", graph=True)
    with pytest.raises(ValueError, match="graph=True needs the parameters on a CUDA"):
        ScoreEngine(cfg, params, Bucket(max_len=16, n_slots=2), None, graph=True)


def test_workloads_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is legal here")
    from repro_torch.workloads import KReorderStability, WorkloadContext
    from repro_torch.workloads.__main__ import main as workloads_main
    cfg = get_config("paper-mlp").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkloadContext.for_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkloadContext()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KReorderStability()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workloads_main(["--plan", str(ROOT / "examples" / "plans" / "paper_mlp.json")])


def test_serve_refuses_params_on_another_device():
    cfg = get_config("paper-mlp").reduced()
    params = init(cfg, device="cpu")
    with pytest.raises(ValueError, match="params are on"):
        TS.serve(cfg, params, torch.zeros(1, 2, dtype=torch.long), 1, device="meta")


def test_other_families_name_their_roadmap_item():
    """The encdec and vlm families build and serve on one device; on a
    two-rank CPU mesh ``forward``, ``prefill``, ``decode_step`` and ``serve``
    of both raise with the ROADMAP item that brings their sharded form."""
    from repro_torch.launch.mesh import spawn
    from _torch_mesh_worker import encdec_vlm_on_a_mesh
    for arch in ("paligemma-3b", "whisper-large-v3"):
        init(get_config(arch).reduced(), device="cpu")
    item = "*Multi-device*, the sharded encoder-decoder and VLM"
    for rank in spawn(encdec_vlm_on_a_mesh, 2, timeout=120, collective_timeout=60):
        assert set(rank) == {"whisper-large-v3", "paligemma-3b"}, rank
        for arch, calls in rank.items():
            assert set(calls) == {"forward", "prefill", "decode_step", "serve"}, calls
            for call, msg in calls.items():
                assert msg and item in msg and arch in msg, (arch, call, msg)


def test_ssm_on_a_mesh_names_the_sharded_ssm():
    """On a two-rank CPU mesh, forward and serve of an SSM model raise with
    the sharded SSM's ROADMAP item."""
    from repro_torch.launch.mesh import spawn
    from _torch_mesh_worker import ssm_on_a_mesh
    for rank in spawn(ssm_on_a_mesh, 2, timeout=120, collective_timeout=60):
        for call in ("forward", "serve"):
            assert rank[call] and "*Multi-device*, the sharded SSM" in rank[call], rank


def test_continuous_engine_refuses_ssm_families():
    """As the reference's: --engine continuous serves KV-cache families only."""
    with pytest.raises(SystemExit, match="family='ssm'"):
        TS.main(["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
                 "--engine", "continuous"])


def test_continuous_engine_refuses_encdec():
    """As the reference's: whisper serves on the simple engine only."""
    for engine in ("continuous", "routed"):
        with pytest.raises(SystemExit, match="family='encdec'"):
            TS.main(["--arch", "whisper-large-v3", "--reduced", "--device", "cpu",
                     "--engine", engine])


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

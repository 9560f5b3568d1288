"""Placed parameters against the JAX package: ``param_specs`` leaf by leaf
against the reference's on its 16x16 axis sizes, every rank's block against
the reference's addressable shard at the same mesh position, and the placed
serve (each rank holding its blocks, every unit gathering its leaves on
use) against the replicated sharded serve, the one-process serve and the
reference's ``--mesh`` serve path; then the bytes at rest, the peak, and
``launch.serve --mesh``.

One 2x2 world of CPU ranks serves the module (``tests/_torch_place_worker.py``,
no JAX). The reference's placements and its ``--mesh`` serve run in a
subprocess on 8 placeholder devices (``tests/_torch_place_jax.py``), started
before the world and read after it. The models are reduced llama3.2-3b
(dense) and reduced dbrx-132b (MoE, 4 experts top-2), with the reference's
seed-0 weights carried across; the prompts (4, 4), 3 tokens generated.

Tolerances: none. A block is a slice of the same weights (``np.array_equal``);
the placed runs gather those slices back whole, so their tokens and logits
equal the replicated sharded run's bit for bit (``np.array_equal``) under
MXU_FP32 and under FDP91, and their tokens equal the one-process serve's
and the reference's.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch.mesh import abstract_mesh  # noqa: E402
from repro.launch.sharding import param_specs as jparam_specs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import all_arch_names, get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch.sharding import PROFILES, param_shardings, param_specs  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.convert import reference_path  # noqa: E402
from repro_torch.models.transformer import init_abstract  # noqa: E402

import _torch_place_worker as W  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"llama": "llama3.2-3b", "dbrx": "dbrx-132b"}
SERVED = ("fsdp", "decode_tp")
PROMPTS, GEN = (4, 4), 3


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def runs():
    trees = {tag: jax.tree.map(np.asarray, JT.init(jget(arch).reduced(), jax.random.key(0)))
             for tag, arch in MODELS.items()}
    cfgs = {tag: tget(arch).reduced() for tag, arch in MODELS.items()}
    prompts = np.random.default_rng(4).integers(0, 256, PROMPTS).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(inp, prompts=prompts,
                 **{f"{tag}/{k}": v for tag, t in trees.items() for k, v in flatten(t).items()})
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        env.pop("XLA_FLAGS", None)
        ref = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_torch_place_jax.py"),
                                inp, out], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        try:
            ranks = TM.spawn(W.world, 4, args=(dict(
                models={tag: (cfgs[tag], trees[tag]) for tag in MODELS}, prompts=prompts,
                gen=GEN, served=SERVED, policies=("native", "fdp91")),), timeout=300,
                collective_timeout=120)
            stdout, stderr = ref.communicate(timeout=300)
        finally:
            ref.kill()
            ref.wait()
        assert ref.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
        z = np.load(out)
        jax_out = {k: z[k] for k in z.files}
    local = {}
    for tag in MODELS:
        params = params_from_numpy(trees[tag], cfgs[tag], device="cpu")
        for policy in ("native", "fdp91"):
            with TD.use_policy(W.POLICIES[policy]):
                local[f"{tag}/{policy}"] = TS.serve(cfgs[tag], params, torch.from_numpy(prompts),
                                                    GEN, device="cpu").numpy()
    return {"ranks": ranks, "jax": jax_out, "trees": trees, "cfgs": cfgs, "local": local}


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", all_arch_names() + ["paper-mlp"])
def test_param_specs_match_the_reference(arch, profile):
    """Every port leaf's spec, the stacked layer dims put back, is the
    reference's spec of the same leaf on its 16x16 mesh; every reference
    leaf has a port leaf."""
    cfg = tget(arch)
    want = flatten(jparam_specs(jget(arch), JT.init_abstract(jget(arch)), profile=profile,
                                mesh=abstract_mesh((16, 16), ("data", "model"))))
    got = param_specs(cfg, init_abstract(cfg), profile, {"data": 16, "model": 16})
    seen = set()
    for name, spec in got.items():
        path, lead = reference_path(name, cfg)
        seen.add(path)
        assert isinstance(want[path], PartitionSpec)
        assert (None,) * len(lead) + spec == tuple(want[path]), (name, spec, want[path])
    assert seen == set(want)


def _shard(runs, tag, mesh, profile, name, pos):
    """The reference's shard of the port's leaf ``name`` at mesh position
    ``pos``, the layer picked out of its stacked dim."""
    path, lead = reference_path(name, runs["cfgs"][tag])
    arr = runs["jax"][f"{tag}/{mesh}/{profile}/{path}/{pos[0]},{pos[1]}"]
    return arr[int(name.split(".")[1])] if lead else arr


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("tag", list(MODELS))
@pytest.mark.parametrize("mesh", ["2x2", "2x4"])
def test_blocks_equal_the_reference_shards(runs, mesh, tag, profile):
    """On 2x2 the blocks each rank of the world holds after ``place``; on
    2x4 the blocks ``Placement.block`` cuts at each of the 8 positions."""
    cfg = runs["cfgs"][tag]
    if mesh == "2x2":
        for r in runs["ranks"]:
            for name, block in r[f"{tag}/{profile}"]["blocks"].items():
                np.testing.assert_array_equal(block, _shard(runs, tag, mesh, profile, name,
                                                            r["coords"]), err_msg=name)
        return
    full = dict(params_from_numpy(runs["trees"][tag], cfg, device="cpu").named_parameters())
    shardings = param_shardings(cfg, init_abstract(cfg), {"data": 2, "model": 4}, profile)
    for i in range(2):
        for j in range(4):
            for name, pl in shardings.items():
                block = pl.block(full[name].detach(), (i, j))
                np.testing.assert_array_equal(block.numpy(), _shard(runs, tag, mesh, profile,
                                                                    name, (i, j)), err_msg=name)


def _same_on_every_rank(runs, key, policy, run, what):
    first = runs["ranks"][0][key][policy][run][what]
    for r in runs["ranks"][1:]:
        np.testing.assert_array_equal(r[key][policy][run][what], first,
                                      err_msg=f"rank {r['rank']} {key} {run} {what}")
    return first


@pytest.mark.parametrize("profile", SERVED)
@pytest.mark.parametrize("tag", list(MODELS))
def test_placed_serve_equals_replicated_local_and_reference(runs, tag, profile):
    """MXU_FP32: the placed serve's tokens equal the replicated sharded
    serve's, the one-process serve's and the reference's --mesh path's; its
    prefill and forward logits equal the replicated sharded run's."""
    key = f"{tag}/{profile}"
    toks = _same_on_every_rank(runs, key, "native", "placed", "tokens")
    assert toks.shape == PROMPTS[:1] + (GEN,)
    np.testing.assert_array_equal(toks, _same_on_every_rank(runs, key, "native", "replicated",
                                                            "tokens"))
    np.testing.assert_array_equal(toks, runs["local"][f"{tag}/native"])
    np.testing.assert_array_equal(toks, runs["jax"][f"serve/{tag}/{profile}"])
    for r in runs["ranks"]:
        for what in ("prefill", "forward"):
            np.testing.assert_array_equal(r[key]["native"]["placed"][what],
                                          r[key]["native"]["replicated"][what],
                                          err_msg=f"rank {r['rank']} {what}")


@pytest.mark.parametrize("profile", SERVED)
@pytest.mark.parametrize("tag", list(MODELS))
def test_placed_serve_is_bit_equal_under_fdp91(runs, tag, profile):
    key = f"{tag}/{profile}"
    toks = _same_on_every_rank(runs, key, "fdp91", "placed", "tokens")
    np.testing.assert_array_equal(toks, runs["local"][f"{tag}/fdp91"])
    for r in runs["ranks"]:
        for what in ("tokens", "prefill", "forward"):
            np.testing.assert_array_equal(r[key]["fdp91"]["placed"][what],
                                          r[key]["fdp91"]["replicated"][what],
                                          err_msg=f"rank {r['rank']} {what}")


@pytest.mark.parametrize("profile", SERVED)
@pytest.mark.parametrize("tag", list(MODELS))
def test_bytes_at_rest_and_peak(runs, tag, profile):
    """A rank's bytes at rest are the sum of its blocks (``param_shardings``),
    below the whole model; the gathered tensors alive at once (tracked until
    freed) added to them stay below the whole model too, and none is alive
    after the serve."""
    key = f"{tag}/{profile}"
    for r in runs["ranks"]:
        run = r[key]
        assert run["bytes"] == run["spec_bytes"] < run["full_bytes"], run
        stats = run["native"]["placed"]["stats"]
        assert stats["calls"] > 0 and stats["received"] > 0, stats
        assert run["bytes"] + stats["peak_live"] < run["full_bytes"], (run["bytes"], stats)
        assert run["live_after"] == 0
        assert run["native"]["replicated"]["stats"]["calls"] == 0


@pytest.mark.parametrize("tag", list(MODELS))
def test_placed_init_draws_the_blocks_of_a_full_draw(runs, tag):
    """``init(..., profile=)`` cutting each unit's host draw gives the blocks
    ``place`` cuts from a whole seed-0 draw, under every profile."""
    for r in runs["ranks"]:
        for profile in PROFILES:
            assert r[f"{tag}/{profile}"]["init_equal"], (r["rank"], profile)


def test_an_indivisible_dim_is_refused(runs):
    """d_model 64 does not split over 3 ranks of "data": the port names the
    leaf, the reference's device_put refuses the same placement."""
    cfg = tget("llama3.2-3b").reduced()
    with pytest.raises(ValueError, match=r"embed under fsdp on 3x1: dim 1 of \(256, 64\) "
                                         r"does not split over \('data',\) \(3 ranks\)"):
        param_shardings(cfg, init_abstract(cfg), {"data": 3, "model": 1}, "fsdp")
    assert "divisible by 3" in str(runs["jax"]["refused_3x1"])


CLI = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch", "2",
       "--prompt-len", "3", "--gen", "3"]


def test_serve_cli_on_a_mesh_matches_the_one_process_cli(capfd):
    local = TS.main(CLI)
    placed = TS.main(CLI + ["--mesh", "2x2", "--profile", "fsdp"])
    assert placed.shape == (2, 3)
    np.testing.assert_array_equal(placed.numpy(), local.numpy())
    out = capfd.readouterr().out
    assert "mesh 2x2 (data gloo, model gloo) profile=fsdp: placed" in out, out


def test_serve_cli_refuses_a_mesh_off_the_simple_engine():
    with pytest.raises(SystemExit, match="--mesh is supported with --engine simple only"):
        TS.main(CLI + ["--mesh", "2x2", "--engine", "continuous"])

"""Weights of the port for a seed do not depend on the device: ``init``
draws every tensor from one CPU ``torch.Generator`` in module order, moves
it to the device and scales it there. On the CPU the model equals the same
draws made by hand; on the card (a test that skips without one) it equals
the CPU's model, bit for bit.

This file imports neither JAX nor the JAX package, so its card test runs
where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_init.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init  # noqa: E402

ARCHS = ["qwen3-0.6b", "dbrx-132b", "paper-mlp"]


def _by_hand(cfg, seed):
    """The parameters as ``init`` must draw them: one CPU generator, module
    order (embed, final_norm, lm_head, then per layer attn_norm, attention,
    mlp_norm, MoE or MLP), each weight a standard normal times fan-in^-1/2;
    norms ones and biases zeros."""
    g = torch.Generator().manual_seed(seed)
    draw = lambda shape, fan_in: torch.randn(shape, generator=g) * fan_in ** -0.5
    d, V, f = cfg.d_model, cfg.padded_vocab, cfg.d_ff
    H, Kh, hd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, cfg.head_dim
    want = {"embed": draw((V, d), d), "final_norm": torch.ones(d),
            "lm_head": draw((d, V), d)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        want[p + "attn_norm"] = torch.ones(d)
        for name, shape, fan_in in (("wq", (d, H), d), ("wk", (d, Kh), d),
                                    ("wv", (d, Kh), d), ("wo", (H, d), H)):
            want[p + "attn." + name] = draw(shape, fan_in)
        if cfg.qkv_bias:
            for name, n in (("bq", H), ("bk", Kh), ("bv", Kh)):
                want[p + "attn." + name] = torch.zeros(n)
        if cfg.qk_norm:
            want[p + "attn.q_norm"] = torch.ones(hd)
            want[p + "attn.k_norm"] = torch.ones(hd)
        want[p + "mlp_norm"] = torch.ones(d)
        if cfg.n_experts:
            E = cfg.n_experts
            for name, shape, fan_in in (("router", (d, E), d), ("w_in", (E, d, f), d),
                                        ("w_gate", (E, d, f), d), ("w_out", (E, f, d), f)):
                want[p + "moe." + name] = draw(shape, fan_in)
        elif f:
            for name, shape, fan_in in (("w_in", (d, f), d), ("w_gate", (d, f), d),
                                        ("w_out", (f, d), f)):
                want[p + "mlp." + name] = draw(shape, fan_in)
    return want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_on_cpu_equals_draws_by_hand(arch):
    cfg = get_config(arch).reduced()
    got = dict(init(cfg, 3, device="cpu").named_parameters())
    want = _by_hand(cfg, 3)
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert torch.equal(got[name].detach(), t), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_init_on_the_card_equals_the_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(arch).reduced()
    on_card = dict(init(cfg, 0, device="cuda").named_parameters())
    for name, t in init(cfg, 0, device="cpu").named_parameters():
        assert on_card[name].device.type == "cuda"
        assert torch.equal(on_card[name].detach(), t.detach().cuda()), name

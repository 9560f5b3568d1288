"""The port's synthetic LM data against the reference's
(``repro.data.synthetic`` under JAX on the CPU).

The bigram transition must be the reference's to the bit: the reference
forms ``(prev * mix + 12345) % v`` on int32 arrays, so the product wraps.
The random draws differ by design (``torch.Generator`` against
``jax.random``), so whole batches are compared through the transition, not
token for token."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

QWEN3_VOCAB, DBRX_VOCAB = 151936, 100352


@pytest.mark.parametrize("vocab", [QWEN3_VOCAB, DBRX_VOCAB])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_bigram_transition_equals_the_reference(vocab, seed):
    """The same numpy ``prev`` values through both packages' hash, with the
    same ``mix`` (both draw it from numpy's generator at ``seed``)."""
    ref = jsyn.SyntheticLM(vocab, 8, 2, seed=seed)
    port = tsyn.SyntheticLM(vocab, 8, 2, seed=seed)
    assert port._mix == ref._mix
    rng = np.random.default_rng(seed + 100)
    prev = np.concatenate([np.arange(153), [vocab - 1, vocab - 2],
                           rng.integers(0, vocab, 2000)]).astype(np.int32)
    want = np.asarray((jnp.asarray(prev) * ref._mix + 12345) % vocab)
    got = tsyn.bigram_next(torch.from_numpy(prev), port._mix, vocab).numpy()
    assert got.min() >= 0 and got.max() < vocab
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vocab", [QWEN3_VOCAB, DBRX_VOCAB])
def test_reference_batches_follow_the_ports_transition(vocab):
    """Run the reference's ``batch``: every target that its noise did not
    draw is the port's ``bigram_next`` of the token before it."""
    seed, step, seq, batch = 3, 5, 64, 4
    ref = jsyn.SyntheticLM(vocab, seq, batch, seed=seed)
    out = ref.batch(step)
    tokens, targets = np.array(out.tokens), np.array(out.targets)
    # the reference's noise draw, as its batch() makes it
    key = jax.random.key((seed * 1_000_003 + step) * 65_537)
    _, k2 = jax.random.split(key)
    noise = np.asarray(jax.random.randint(k2, (batch, seq), 0, vocab, jnp.int32))
    hashed = noise % 4 != 0
    assert hashed.sum() > batch * seq // 2
    np.testing.assert_array_equal(targets[~hashed], noise[~hashed])
    nxt = tsyn.bigram_next(torch.from_numpy(tokens), ref._mix, vocab).numpy()
    np.testing.assert_array_equal(nxt[hashed], targets[hashed])


def test_port_batches_follow_the_transition():
    """The port's own batches: tokens are the targets shifted by one, and at
    least the noise-free three quarters of targets are the transition of
    the token before them."""
    vocab = 1000
    data = tsyn.SyntheticLM(vocab, 32, 8, seed=2)
    b = data.batch(4)
    assert torch.equal(b.tokens[:, 1:], b.targets[:, :-1])
    nxt = tsyn.bigram_next(b.tokens, data._mix, vocab)
    assert float((nxt == b.targets).float().mean()) >= 0.7
    assert torch.equal(data.batch(4).targets, b.targets)

"""The port's ``SyntheticLMData`` against the reference's ``jax.random``
stream, on the same (seed, step).

The port computes threefry2x32 in torch integer ops, so these must be
byte-equal to the reference's: the keys of ``PRNGKey`` / ``fold_in`` /
``split``, the 32-bit random bits and the float32 uniforms.  The tokens
``int32(vocab ** u - 1)`` take ``vocab ** u`` as a float64 power rounded
to float32 (correctly rounded), where XLA's float32 power may differ by
an ulp: the tokens are equal wherever the two float32 powers are, and
elsewhere differ by at most 1, at under 1e-3 of positions.  The patches
(``jax.random.normal``) go through ``torch.erfinv`` for XLA's
``erf_inv``: within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import data as jdata  # noqa: E402
from repro import configs as jcfg  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402

FULL_VOCAB = 151936                # Qwen3-30B-A3B
PATCH_ATOL = 1e-6
SEEDS = [(0, 0), (0, 1), (3, 7), (2**31 + 5, 123456)]


def _ref_keys(seed, step):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    return key, jax.random.split(key)


@pytest.mark.parametrize("seed,step", SEEDS)
def test_keys_match_jax_random(seed, step):
    if seed >= 2**31:
        with jax.enable_x64(True):
            key, (k1, k2) = _ref_keys(seed, step)
    else:
        key, (k1, k2) = _ref_keys(seed, step)
    got = pipeline._fold_in(pipeline._prng_key(seed), step)
    assert got == tuple(int(v) for v in np.asarray(key))
    t1, t2 = pipeline._split2(got)
    assert t1 == tuple(int(v) for v in np.asarray(k1))
    assert t2 == tuple(int(v) for v in np.asarray(k2))


@pytest.mark.parametrize("seed,step", SEEDS[:3])
@pytest.mark.parametrize("shape", [(8, 4096), (3, 7), (1,)])
def test_bits_and_uniform_byte_equal(seed, step, shape):
    _, (k1, _) = _ref_keys(seed, step)
    t1, _ = pipeline._split2(pipeline._fold_in(pipeline._prng_key(seed),
                                               step))
    bits = pipeline._random_bits(t1, shape, "cpu").numpy().astype(np.uint32)
    assert bits.tobytes() == np.asarray(jax.random.bits(k1, shape)).tobytes()
    u = pipeline._uniform(t1, shape, 1e-6, 1.0, "cpu").numpy()
    want = np.asarray(jax.random.uniform(k1, shape, minval=1e-6, maxval=1.0))
    assert u.tobytes() == want.tobytes()


@pytest.mark.parametrize("vocab,batch,seq", [(FULL_VOCAB, 64, 4096),
                                             (256, 8, 128)])
def test_tokens_match_where_the_powers_do(vocab, batch, seq):
    ref = jdata.SyntheticLMData(vocab=vocab, seq_len=seq, global_batch=batch,
                                seed=0)
    port = SyntheticLMData(vocab=vocab, seq_len=seq, global_batch=batch,
                           seed=0, device="cpu")
    for step in (0, 5):
        want = np.asarray(ref.batch(step)["tokens"])
        got = port.batch(step)["tokens"]
        assert got.dtype == torch.int32 and got.shape == (batch, seq)
        got = got.numpy()
        _, (k1, _) = _ref_keys(0, step)
        u = jax.random.uniform(k1, (batch, seq), minval=1e-6, maxval=1.0)
        pw_ref = np.asarray(vocab ** u)
        pw_port = torch.pow(float(vocab), torch.from_numpy(
            np.asarray(u).astype(np.float64))).float().numpy()
        same = pw_ref.view(np.uint32) == pw_port.view(np.uint32)
        assert np.array_equal(got[same], want[same])
        diff = np.abs(got.astype(np.int64) - want)
        assert diff.max() <= 1
        off = int((diff != 0).sum())
        print(f"vocab {vocab} step {step}: powers differ at "
              f"{int((~same).sum())} of {same.size}, tokens at {off}")
        assert off < 1e-3 * got.size
        assert got.min() >= 0 and got.max() < vocab


def test_patches_of_internvl2_smoke():
    cfg = jcfg.get_smoke_config("internvl2_26b")
    kw = dict(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=4,
              num_patches=cfg.num_patches, d_model=cfg.d_model)
    want = jdata.SyntheticLMData(**kw).batch(3)
    got = SyntheticLMData(**kw, device="cpu").batch(3)
    assert got["patches"].dtype == torch.float32
    assert got["patches"].shape == (2, cfg.num_patches, cfg.d_model)
    err = float(np.max(np.abs(got["patches"].numpy()
                              - np.asarray(want["patches"]))))
    assert err <= PATCH_ATOL, err
    assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


def test_normal_matches_within_tolerance():
    _, (_, k2) = _ref_keys(9, 2)
    t2 = pipeline._split2(pipeline._fold_in(pipeline._prng_key(9), 2))[1]
    got = pipeline._normal(t2, (64, 512), "cpu").numpy()
    want = np.asarray(jax.random.normal(k2, (64, 512), jnp.float32))
    assert np.max(np.abs(got - want)) <= 5e-6 * np.max(np.abs(want))


def test_data_restart_exact():
    d = SyntheticLMData(vocab=100, seq_len=16, global_batch=4, seed=3,
                        device="cpu")
    b1, b2 = d.batch(7), d.batch(7)          # a "restarted" pipeline
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(d.batch(8)["tokens"], b1["tokens"])
    it = iter(d)
    assert torch.equal(next(it)["tokens"], d.batch(0)["tokens"])
    assert torch.equal(next(it)["tokens"], d.batch(1)["tokens"])

"""The port's embedding lookup (``models.transformer._embed_rows``).

* Its backward adds in a fixed order: one ``loss_fn`` backward of
  ``examples/torch_train_moe.py``'s small config, repeated from the same
  parameters at ``THREADS`` intra-op threads, gives the same gradient bits
  every time.  (The index form ``embed[tokens]`` failed this: its CPU
  backward, ``index_put`` with accumulate, adds the rows of repeated
  tokens in whatever order the threads reach them.)
* It copies rows: the first layer's input of ``forward`` and of
  ``decode_step`` equals the reference's lookup on the same parameters
  and ids, bit for bit, for every architecture's smoke config.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.core.interop import tree_flatten  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                init_params, loss_fn, params_from_reference)
from repro_torch.models import transformer as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: intra-op threads of the repeat test (at least 4, so the order of a
#: threaded sum could show); REPEATS backward passes from one state
THREADS, REPEATS = 8, 12
B, S = 2, 16


@pytest.fixture
def threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield THREADS
    torch.set_num_threads(prev)


def _train_moe_cfg():
    spec = importlib.util.spec_from_file_location(
        "port_train_moe_cfg", ROOT / "examples" / "torch_train_moe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_cfg(small=True)


def test_loss_backward_repeats_bit_for_bit(threads):
    """``train_moe``'s small config at its seq 64 and batch 4: every
    gradient leaf of ``REPEATS`` backward passes bit-identical."""
    assert torch.get_num_threads() == threads >= 4
    cfg = _train_moe_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = tree_flatten(params)[0]
    for t in leaves:
        t.requires_grad_(True)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (4, 64))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    assert len(np.unique(tokens)) < tokens.size      # repeated tokens
    runs = []
    for _ in range(REPEATS):
        loss, _ = loss_fn(params, cfg, batch, remat=cfg.remat)
        runs.append(torch.autograd.grad(loss, leaves))
    first = runs[0]
    for grads in runs[1:]:
        for i, (a, b) in enumerate(zip(first, grads)):
            assert torch.equal(a, b), f"leaf {i} of {len(leaves)} differs"


class _FirstLayer(Exception):
    """Raised by the first block with its input, to stop the model."""


def _first_layer_input(monkeypatch, name, call):
    def capture(bp, x, *args, **kw):
        raise _FirstLayer(x)
    monkeypatch.setattr(T, name, capture)
    with pytest.raises(_FirstLayer) as got:
        call()
    return got.value.args[0]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("path", ["forward", "decode_step"])
def test_first_layer_input_equals_reference(monkeypatch, arch, path):
    """Tolerance 0: a lookup copies rows (and ``forward`` of a vlm puts
    the cast patches in front of them)."""
    jc, cfg = jcfg.get_smoke_config(arch), get_smoke_config(arch)
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    params = params_from_reference(cfg, jp, device="cpu")
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    tokens[1, :4] = tokens[0, :4]                    # repeated ids
    batch = {"tokens": tokens}
    if cfg.frontend == "vision_patches":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if path == "forward":
        want = jtr._embed_inputs(jp, jc, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        got = _first_layer_input(monkeypatch, "_block_fwd", lambda: forward(
            params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}))
    else:
        token = tokens[:, 5:6]
        want = jp["embed"][jnp.asarray(token)]
        cache = init_cache(cfg, B, 8, device="cpu")
        got = _first_layer_input(monkeypatch, "_block_decode",
                                 lambda: decode_step(params, cfg, token,
                                                     cache))
    want = np.asarray(want)
    got = got.detach()
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16)
    assert got.shape == want.shape and np.array_equal(got.numpy(),
                                                      _bits(want))

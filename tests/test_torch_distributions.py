"""The port's own copy of the key distributions returns the reference's
arrays for the same seed, dtype and parameters."""
import numpy as np
import pytest

from repro.data import distributions as jd
from repro_torch.data import distributions as td


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.uint64])
@pytest.mark.parametrize("ands", [0, 1, 3])
def test_entropy_keys(dtype, ands):
    assert _same(td.entropy_keys(7, 1000, ands, dtype),
                 jd.entropy_keys(7, 1000, ands, dtype))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64, np.int16])
@pytest.mark.parametrize("a", [1.2, 1.5])
def test_zipf_keys(dtype, a):
    assert _same(td.zipf_keys(11, 1000, a, dtype),
                 jd.zipf_keys(11, 1000, a, dtype))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("clusters, spread", [(64, 1 << 16), (3, 1), (1, 0)])
def test_clustered_keys(dtype, clusters, spread):
    assert _same(td.clustered_keys(5, 1000, clusters, spread, dtype),
                 jd.clustered_keys(5, 1000, clusters, spread, dtype))


def test_constant_keys_and_generators():
    assert _same(td.constant_keys(10, 3, np.uint64),
                 jd.constant_keys(10, 3, np.uint64))
    g1, g2 = np.random.default_rng(3), np.random.default_rng(3)
    assert _same(td.entropy_keys(g1, 50, 2), jd.entropy_keys(g2, 50, 2))
    assert td.as_generator(g1) is g1
    seq = np.random.SeedSequence(9)
    assert _same(td.as_generator(seq).integers(0, 9, 5),
                 jd.as_generator(seq).integers(0, 9, 5))
    with pytest.raises(TypeError):
        td.as_generator(None)
    assert td.ENTROPY_BITS_32 == jd.ENTROPY_BITS_32


def test_port_copy_imports_no_reference():
    import ast
    from pathlib import Path
    tree = ast.parse(Path(td.__file__).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert roots <= {"numpy", "__future__"}

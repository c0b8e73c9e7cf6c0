"""``repro_torch.hybrid_sort`` at d = 16 against ``repro.core.hybrid_sort``
(the cases of ``tests/test_torch_hybrid_wide.py::wide_digit_case`` at the
widest digit, in a file of their own so that ``--dist loadfile`` runs them
on another worker)."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from test_torch_hybrid_wide import wide_digit_case  # noqa: E402


@pytest.mark.parametrize("d", [16])
@pytest.mark.parametrize("keys", ["uniform", "and3"])
@pytest.mark.parametrize("with_values", [False, True])
def test_wide_digit_parity(rng, d, keys, with_values):
    wide_digit_case(rng, d, keys, with_values)

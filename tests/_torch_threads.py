"""One intra-op torch thread for the duration of a port test file.

The tier-1 command runs the tests on several xdist workers with
``--dist loadfile``, which keeps a whole file on one worker.  Each
worker's default torch thread pool is as wide as the machine, so the
workers' pools oversubscribe its CPUs, and a small model's CPU step runs
about three times slower than on one thread.  A test file that imports
``one_thread`` runs on one thread and gives the old count back after its
last test.  The port's CPU training repeats bit for bit at any thread
count (``tests/test_torch_embedding.py`` pins that at several threads),
so the count changes no result a test compares exactly with another run.
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

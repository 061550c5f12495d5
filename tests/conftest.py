"""Settings shared by the test modules under ``tests/``."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread(request):
    """Torch on one intra-op thread in each of the port's test modules
    (``test_torch_*.py``), and in the subprocesses they start: the suite's
    workers share the host's cores, and a process's threads past one only
    contend for them. The reference's modules neither import torch here
    nor see the rule."""
    if not request.path.name.startswith("test_torch_"):
        yield
        return
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)

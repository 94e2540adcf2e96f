import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for torch in these tests: they run beside the other
    test files' workers, and small products gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

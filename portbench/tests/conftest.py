import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Several test workers share the host: a few threads each keep the
    serving tests' steps, which run against a clock, from starving."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

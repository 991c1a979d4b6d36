"""A conditional node's body is captured on a side stream that no capture
uses.  torch hands out new streams round-robin from a fixed pool, and
`torch.cuda.graph` captures on one of that pool's streams, so a body that
took the next stream of the pool could land on the capturing stream
itself (`cudaStreamBeginCaptureToGraph` then fails with CUDA error 401).
The test turns the pool until its next stream is the capturing one, then
opens IF and WHILE bodies.

Needs a CUDA card (marker `cuda`; each test skips without one):

    python -m pytest tests/test_torch_graph_streams_cuda.py -q
"""

import pytest
import torch

from paddle_tpu_torch.inference import graphs

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _turn_pool_to(stream):
    """Draw streams from torch's pool until the next one drawn is `stream`."""
    hit = lambda: torch.cuda.Stream().cuda_stream == stream.cuda_stream  # noqa: E731
    for _ in range(4096):
        if hit():
            break
    else:
        pytest.fail("the capturing stream is not one of torch's pool streams")
    period = 1
    while not hit():
        period += 1
    for _ in range(period - 1):
        torch.cuda.Stream()


@pytest.mark.parametrize("loop", [False, True], ids=["if", "while"])
def test_a_body_never_takes_the_capturing_stream(card, loop):
    x = torch.zeros(1, device=card)
    pred = torch.ones(1, dtype=torch.bool, device=card)

    def body():
        _turn_pool_to(torch.cuda.current_stream())
        if loop:
            with graphs.conditional_body(x < 3, loop=True) as next_pass:
                x.add_(1)
                next_pass(x < 3)
        else:
            with graphs.conditional_body(pred):
                x.add_(1)
        return x

    graph, _, _, _ = graphs.capture(body, card)
    x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert x.item() == (3.0 if loop else 1.0)
    pred.fill_(False)
    x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert x.item() == (3.0 if loop else 0.0)

"""FLAGS_check_nan_inf on the card: the check reads what operators and
kernels wrote, never memory as the caching allocator hands it out.  The
kernels' wrappers allocate their outputs with `empty_like` and write them
by pointer; a block that last held float32 NaN, reused as bfloat16, is
NaN in every other element.  Clean steps over such memory raise nothing,
and a non-finite value a kernel writes raises naming the kernel.

Needs a CUDA card (marker `cuda`; each test skips without one):

    python -m pytest tests/test_torch_nan_check_cuda.py -q
"""

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from paddle_tpu_torch import amp, jit, optimizer
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# bf16, head_dim 64, 256 rows: K1 and K3 on their wgmma kernels
CFG = LlamaConfig.tiny(vocab_size=1000, hidden_size=512, intermediate_size=1024,
                       num_attention_heads=8, num_key_value_heads=8,
                       max_position_embeddings=512)
BATCH, SEQ = 2, 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda")
    core.set_flags({"FLAGS_check_nan_inf": False})
    torch.cuda.empty_cache()


def _poison(grad=None):
    """Make the allocator's free blocks all float32 NaN: the cache emptied,
    then 1 GiB of 64 MiB blocks and 256 blocks of 512 KiB (the small-block
    pool) filled and freed, past every dispatch mode (the fill itself is
    NaN).  Not inside a capture, whose pool is the graph's own.  Run as a
    hook on the loss, it leaves the backward's kernels (K3 and the rest)
    nothing but such blocks to allocate from."""
    if torch.cuda.is_current_stream_capturing():
        return
    with _disable_current_modes():
        torch.cuda.empty_cache()
        blocks = [torch.full((16 << 20,), float("nan"), device="cuda") for _ in range(16)]
        blocks += [torch.full((128 << 10,), float("nan"), device="cuda")
                   for _ in range(256)]
        del blocks


def _train():
    """bench_llama's step (bf16 O2, AdamW) on a small Llama, its backward
    over an allocator full of NaN (`_poison`): (step, ids)."""
    model = LlamaForCausalLM(CFG, device="cuda", dtype="float32", seed=0).train()
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")

    def step(ids):
        loss, _ = model(ids, labels=ids)
        loss.register_hook(_poison)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(1, CFG.vocab_size, (BATCH, SEQ), generator=gen, device="cuda",
                        dtype=torch.int32)
    return step, ids


def test_eager_step_over_reused_memory_raises_nothing(card):
    step, ids = _train()
    fa.reset_launch_counts()
    core.set_flags({"FLAGS_check_nan_inf": True})
    losses = [float(step(ids).detach()) for _ in range(2)]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert fa.launch_counts["flash_fwd"] > 0 and fa.launch_counts["flash_bwd"] > 0


def test_captured_step_over_reused_memory_raises_nothing(card):
    train, ids = _train()
    step = jit.to_static(train)
    core.set_flags({"FLAGS_check_nan_inf": True})  # the warm run's backward over NaN blocks
    losses = [float(step(ids)) for _ in range(3)]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert step.trace_count == 1


def test_kernel_output_nan_raises_naming_the_kernel(card):
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, g = (torch.randn(BATCH, SEQ, 8, 64, generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_forward(q, k, v, causal=True)
    g[0, 0, 0, 0] = float("nan")
    core.set_flags({"FLAGS_check_nan_inf": True})
    with pytest.raises(FloatingPointError, match="'flash_bwd'"):
        fa.flash_backward(q, k, v, out, lse, g, causal=True)

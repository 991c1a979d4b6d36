"""The optimizer's multi-tensor update and unscale (`ops/optim.py`) against
the JAX package's per-parameter Adam and `GradScaler.unscale_`, on the CPU.

On CPU tensors `adam_multi` and `unscale_multi` run their plain versions
(`adam_multi_plain`, `unscale_multi_plain`); the CUDA kernels
(`csrc/optim.cu`) are held against those on the card by `chip_smoke.py`.
Here the port's `Adam` / `AdamW` (which call `adam_multi`) take three
steps beside the reference's over one list mixing a float32 parameter
without a master, bf16 ones with float32 masters and a bf16 one without:

- float32 values (parameters, masters, moments, powers) within atol/rtol
  1e-6: the same float32 operations in the same order;
- a bf16 parameter without a master within one bf16 ulp (rtol 2^-8): both
  round the same float32 update, which may sit on either side of a
  rounding boundary when the float32 values differ in the last place.

The host side of a launch -- the entry and chunk tables, what the wrapper
passes the C entry point, the current pointers in every step's entries -- is
checked with a recorder in place of the kernel library.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import to_tensor
from paddle_tpu_torch import optimizer, regularizer
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import optim

TOL = dict(atol=1e-6, rtol=1e-6)
BF16_TOL = dict(atol=0, rtol=2 ** -8)

SHAPES = [(5, 3), (7,), (4, 2), (6,)]
NAMES = ["f32.weight", "a.weight", "b.weight", "norm.weight"]
# 0: float32, no master; 1: bf16 + master; 2: bf16, no master; 3: bf16 + master
LOW = [False, True, True, True]


def _inputs(seed, steps=3):
    rng = np.random.default_rng(seed)
    w0s = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    grads[0][3] = None  # no gradient in step 1: its powers lag one step
    return w0s, grads


def _ref(cls, w0s, grads, **kw):
    ps = [paddle.Parameter(w.copy(), dtype="bfloat16" if low else "float32",
                           name=f"{cls}_{n}_{id(grads)}")
          for w, low, n in zip(w0s, LOW, NAMES)]
    opt = getattr(paddle.optimizer, cls)(learning_rate=0.05, parameters=ps,
                                         multi_precision=True, **kw)
    del opt._master_weights[ps[2].name]
    for gs in grads:
        sum((p * to_tensor(g, dtype=p.dtype)).sum()
            for p, g in zip(ps, gs) if g is not None).backward()
        opt.step()
        opt.clear_grad()
    return ps, opt


def _port(cls, w0s, grads, **kw):
    ps = [torch.nn.Parameter(torch.from_numpy(w.copy()).to(
        torch.bfloat16 if low else torch.float32)) for w, low in zip(w0s, LOW)]
    opt = getattr(optimizer, cls)(learning_rate=0.05,
                                  parameters=list(zip(NAMES, ps)),
                                  multi_precision=True, **kw)
    del opt.state[ps[2]]["master_weight"]
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = None if g is None else torch.from_numpy(g).to(p.dtype)
        opt.step()
        opt.clear_grad()
    return ps, opt


# keyword arguments from a regularizer module: each package takes its own
CASES = {
    "adamw": ("AdamW", lambda reg: {}),                      # decoupled 0.01
    "adamw_exempt": ("AdamW", lambda reg: {
        "weight_decay": 0.2, "apply_decay_param_fun": lambda n: "norm" not in n}),
    "adamw_l1": ("AdamW", lambda reg: {"weight_decay": reg.L1Decay(0.1)}),
    "adam_l2_float": ("Adam", lambda reg: {"weight_decay": 0.1}),  # into the grad
    "adam_l2": ("Adam", lambda reg: {"weight_decay": reg.L2Decay(0.1)}),
    "adam_l1": ("Adam", lambda reg: {"weight_decay": reg.L1Decay(0.05)}),
    "adam_lazy": ("Adam", lambda reg: {"lazy_mode": True}),  # dense grads: no change
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_tensor_adam_matches_reference(case):
    cls, kw = CASES[case]
    w0s, grads = _inputs(len(case))
    rps, ropt = _ref(cls, w0s, grads, **kw(paddle.regularizer))
    tps, topt = _port(cls, w0s, grads, **kw(regularizer))
    for i, (r, t) in enumerate(zip(rps, tps)):
        st = topt.state[t]
        master = ropt._master_weights.get(r.name)
        if master is not None:
            np.testing.assert_allclose(st["master_weight"].numpy(), master.numpy(),
                                       **TOL)
            assert torch.equal(t.detach(), st["master_weight"].bfloat16())
        elif LOW[i]:
            np.testing.assert_allclose(t.detach().float().numpy(),
                                       r.astype("float32").numpy(), **BF16_TOL)
        else:
            np.testing.assert_allclose(t.detach().numpy(), r.numpy(), **TOL)
        for acc in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            ref_acc = ropt._accumulators[(acc, r.name)].numpy()
            np.testing.assert_allclose(st[acc].numpy(), ref_acc, **TOL)
    # the parameter that missed step 1 advanced its powers twice, not three times
    np.testing.assert_allclose(topt.state[tps[3]]["beta1_pow"].item(), 0.9 ** 2,
                               rtol=1e-6)
    np.testing.assert_allclose(topt.state[tps[0]]["beta1_pow"].item(), 0.9 ** 3,
                               rtol=1e-6)


def _snapshot(opt, ps):
    return [t.clone() for p in ps for t in [p.detach(), *opt.state[p].values()]]


def test_found_inf_changes_nothing_bit_for_bit():
    w0s, grads = _inputs(3)
    tps, topt = _port("AdamW", w0s, grads[:2])
    before = _snapshot(topt, tps)
    for p, g in zip(tps, grads[2]):
        p.grad = torch.from_numpy(g).to(p.dtype)
    topt.step(found_inf=torch.ones((), dtype=torch.int32))
    after = _snapshot(topt, tps)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    topt.step(found_inf=torch.zeros((), dtype=torch.int32))  # a clear flag steps
    assert not all(torch.equal(a, b) for a, b in zip(before, _snapshot(topt, tps)))


def test_adam_multi_plain_is_the_update_of_adam():
    """Calling the plain version on explicit lists gives the optimizer's
    state bit for bit."""
    w0s, grads = _inputs(4, steps=1)
    grads[0][3] = np.ones(SHAPES[3], np.float32)
    tps, topt = _port("AdamW", w0s, grads)
    ps = [torch.from_numpy(w.copy()).to(torch.bfloat16 if low else torch.float32)
          for w, low in zip(w0s, LOW)]
    masters = [p.float() if low and i != 2 else None
               for i, (p, low) in enumerate(zip(ps, LOW))]
    m = [torch.zeros(s) for s in SHAPES]
    v = [torch.zeros(s) for s in SHAPES]
    p1 = [torch.ones(()) for _ in SHAPES]
    p2 = [torch.ones(()) for _ in SHAPES]
    gs = [torch.from_numpy(g).to(p.dtype) for p, g in zip(ps, grads[0])]
    optim.adam_multi_plain(ps, gs, masters, m, v, p1, p2,
                           [(0.01, "decoupled")] * 4, torch.tensor(0.05), 0.9, 0.999,
                           1e-8)
    for i, p in enumerate(tps):
        assert torch.equal(ps[i], p.detach())
        assert torch.equal(m[i], topt.state[p]["moment1"])
        assert torch.equal(v[i], topt.state[p]["moment2"])


@pytest.mark.parametrize("inject", [False, True])
def test_unscale_multi_matches_reference(inject):
    rng = np.random.default_rng(11)
    gs = [(1000 * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
    if inject:
        gs[2][1, 1] = np.inf
    rps = [paddle.Parameter(np.zeros(s, np.float32),
                            dtype="bfloat16" if low else "float32",
                            name=f"u{inject}_{i}")
           for i, (s, low) in enumerate(zip(SHAPES, LOW))]
    for p, g in zip(rps, gs):
        p.grad = to_tensor(g, dtype=p.dtype)
    ropt = paddle.optimizer.SGD(learning_rate=0.1, parameters=rps)
    scaler = paddle.amp.GradScaler(init_loss_scaling=256.0)
    scaler.unscale_(ropt)
    tgrads = [torch.from_numpy(g).to(torch.bfloat16 if low else torch.float32)
              for g, low in zip(gs, LOW)]
    found = torch.zeros((), dtype=torch.int32)
    optim.unscale_multi(tgrads, torch.tensor(256.0), found)
    for r, t in zip(rps, tgrads):
        np.testing.assert_array_equal(t.float().numpy(),
                                      r.grad.astype("float32").numpy())
    assert bool(found) == inject == bool(scaler._found_inf.numpy())
    assert optim.launch_counts["unscale_fused"] == 0  # CPU: the plain version


# ---------------------------------------------------------------------------
# the host side of a launch
# ---------------------------------------------------------------------------


def test_chunk_table_covers_every_element_once():
    table = optim.MultiTensorTable()
    numels = np.array([1, optim.CHUNK, optim.CHUNK + 1, 3 * optim.CHUNK - 5])
    c = table._chunk_table(numels)
    assert c.dtype.itemsize == 8
    assert list(zip(c["tensor"], c["index"])) == [
        (0, 0), (1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2)]
    assert table._chunk_table(numels.copy()) is c  # cached while sizes hold


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: the C library records its
    calls and the upload records the tables."""
    lib = _Recorder()
    uploads = []

    def upload(self, entries, device):
        chunks = self._chunk_table(entries["numel"])
        uploads.append((entries.copy(), chunks))
        return 1000, 2000, len(entries), len(chunks)

    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(optim, "_on_cuda", lambda tensors, what: True)
    monkeypatch.setattr(optim, "_stream", lambda t: 0)
    monkeypatch.setattr(optim.MultiTensorTable, "upload", upload)
    optim.reset_launch_counts()
    return lib, uploads


def test_adam_wrapper_packs_the_entries_and_launches_once(fake_card):
    lib, uploads = fake_card
    w0s, grads = _inputs(6, steps=2)
    grads[0][3] = np.ones(SHAPES[3], np.float32)
    tps, topt = _port("AdamW", w0s, grads[:1],
                      weight_decay=regularizer.L1Decay(0.1),
                      apply_decay_param_fun=lambda n: n != "a.weight")
    assert optim.launch_counts == {"adam_fused": 1, "unscale_fused": 0}
    (name, args), = lib.calls
    assert name == "ptt_adam_multi"
    assert args[:5] == (1000, 2000, 4, 4, optim.CHUNK)
    assert args[5] == topt._lr_t.data_ptr()
    np.testing.assert_allclose(args[6:11], [0.9, 0.999, 0.1, 0.001, 1e-8])
    assert args[11] is None  # no found_inf
    entries, _ = uploads[0]
    st = [topt.state[p] for p in tps]
    assert list(entries["param"]) == [p.data_ptr() for p in tps]
    assert list(entries["master"]) == [
        s["master_weight"].data_ptr() if "master_weight" in s else 0 for s in st]
    assert list(entries["m"]) == [s["moment1"].data_ptr() for s in st]
    assert list(entries["pow2"]) == [s["beta2_pow"].data_ptr() for s in st]
    assert list(entries["numel"]) == [p.numel() for p in tps]
    np.testing.assert_allclose(entries["wd"], [0.1, 0.0, 0.1, 0.1])
    # dtype code | L1 (4) | decoupled (8)
    assert list(entries["flags"]) == [0 | 12, 1 | 12, 1 | 12, 1 | 12]


def test_adam_wrapper_repacks_when_a_pointer_changes(fake_card):
    """Every step packs every entry from the current pointers: new
    gradients, a parameter's swapped `.data` (as amp.decorate does) and a
    swapped moment all reach the next launch."""
    lib, uploads = fake_card
    w0s, grads = _inputs(7, steps=1)
    grads[0][3] = np.ones(SHAPES[3], np.float32)
    tps, topt = _port("AdamW", w0s, grads)

    def step():
        for p, g in zip(tps, grads[0]):
            p.grad = torch.from_numpy(g).to(p.dtype)
        topt.step()
        return uploads[-1][0]

    entries = step()
    assert list(entries["grad"]) == [p.grad.data_ptr() for p in tps]
    tps[1].data = tps[1].data.clone()
    st = topt.state[tps[2]]
    st["moment2"].data = st["moment2"].data.clone()
    entries = step()
    assert list(entries["param"]) == [p.data_ptr() for p in tps]
    assert entries["v"][2] == st["moment2"].data_ptr()
    assert list(entries["grad"]) == [p.grad.data_ptr() for p in tps]
    assert optim.launch_counts["adam_fused"] == 3


def test_scaler_skip_reaches_the_kernel_as_a_device_flag(fake_card):
    from paddle_tpu_torch import amp

    lib, _ = fake_card
    w0s, grads = _inputs(8, steps=1)
    grads[0][3] = np.ones(SHAPES[3], np.float32)
    ps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0s]
    opt = optimizer.AdamW(parameters=ps)
    scaler = amp.GradScaler()
    for p, g in zip(ps, grads[0]):
        p.grad = torch.from_numpy(g)
    scaler.step(opt)
    names = [n for n, _ in lib.calls]
    assert names == ["ptt_unscale_multi", "ptt_adam_multi"]
    found_ptr = scaler._found_inf.data_ptr()
    assert lib.calls[0][1][5] == found_ptr and lib.calls[1][1][11] == found_ptr
    assert optim.launch_counts == {"adam_fused": 1, "unscale_fused": 1}


@pytest.mark.parametrize("bad, err", [
    (lambda g: g.t().contiguous().t(), "contiguous"),
    (lambda g: g.double(), "grad"),
    (lambda g: g[:2], "grad"),
])
def test_adam_wrapper_refuses_what_the_kernel_does_not_take(fake_card, bad, err):
    p = torch.zeros(4, 3)
    state = [torch.zeros(4, 3), torch.zeros(4, 3), torch.ones(()), torch.ones(())]
    with pytest.raises(ValueError, match=err):
        optim.adam_multi([p], [bad(torch.ones(4, 3))], [None], *[[t] for t in state],
                         [(0.0, "decoupled")], torch.tensor(0.1), 0.9, 0.999, 1e-8)
    assert optim.launch_counts["adam_fused"] == 0


def test_wrapper_refuses_a_mix_of_devices():
    with pytest.raises(ValueError, match="devices"):
        optim._on_cuda([torch.zeros(1), torch.zeros(1, device="meta")], "adam_multi")

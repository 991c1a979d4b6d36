"""The port's inference export against the JAX package's, on the CPU.

The counterparts of `tests/test_auto_parallel_static.py`'s
`TestStaticInference` and `TestServing`, and of the reference's
`jit.save` / `jit.load` contract: each model is built in both packages on
the same weights (`load_reference_state`), exported by each, and the
port's `Predictor` is held against the reference's `Predictor.run` on the
same numpy inputs (float32, to 1e-5: the same math summed in another
order) and against the live port model bit for bit (the program runs the
port's own operators).  The exported graph keeps K1 as
`paddle_tpu_torch::flash_fwd` nodes, with no attention traced into
einsums.  The reference's `inference.serve` is never started here: it
installs a SIGTERM handler it never puts back.
"""

import json
import logging
import pathlib
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu import static as jstatic
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import inference, jit, static
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
FLASH = torch.ops.paddle_tpu_torch.flash_fwd.default
INLINED = ("aten.einsum", "aten.bmm", "aten._softmax", "aten.softmax", "aten.logsumexp")


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX models draws from paddle_tpu's global generator,
    the port's Linears from torch's; restore both so later modules see the
    streams as if this one never ran."""
    state, torch_state = paddle.get_rng_state(), torch.get_rng_state()
    yield
    paddle.set_rng_state(state)
    torch.set_rng_state(torch_state)


def _state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _mlp_pair():
    """The reference tests' MLP in both packages, on the same weights."""
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    jm.eval()
    tm = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))
    load_reference_state(tm, _state(jm))
    return jm, tm.eval()


def _x():
    return np.random.RandomState(0).rand(2, 4).astype(np.float32)


class _JClassify(jnn.Layer):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids, mask):
        return self.model(ids, attention_mask=mask)


class _TClassify(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids, mask):
        return self.model(ids, attention_mask=mask)


def _bert_pair():
    paddle.seed(5)
    jm = jbert.BertForSequenceClassification(jbert.BertConfig.tiny(**NO_DROPOUT))
    tm = tbert.BertForSequenceClassification(tbert.BertConfig.tiny(**NO_DROPOUT),
                                             device="cpu")
    load_reference_state(tm, _state(jm))
    jm.eval()
    return _JClassify(jm), _TClassify(tm)


def _bert_batch(seed=1, b=2, s=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 10:] = 0
    return ids, mask


def _flash_nodes(predictor):
    nodes = [n for n in predictor.program.graph.nodes if n.op == "call_function"]
    inlined = [str(n.target) for n in nodes if str(n.target).startswith(INLINED)]
    return sum(n.target is FLASH for n in nodes), inlined


def test_save_load_inference_model_matches_the_reference(tmp_path):
    jm, tm = _mlp_pair()
    x = _x()
    jstatic.save_inference_model(str(tmp_path / "j"), [paddle.to_tensor(x)], None, None,
                                 program=jm)
    jpred, _, _ = jstatic.load_inference_model(str(tmp_path / "j"), None)
    want = jpred.run([x])[0]
    static.save_inference_model(str(tmp_path / "t"), [torch.from_numpy(x)], None, None,
                                program=tm)
    pred, feeds, fetches = static.load_inference_model(
        str(tmp_path / "t"), static.Executor(static.cpu_places()[0]))
    assert feeds == ["x0"] and fetches == ["y0"]
    got = pred.run([x])[0]
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        assert np.array_equal(got, tm(torch.from_numpy(x)).numpy())
    assert (tmp_path / "t.pt2").is_file() and (tmp_path / "t.pdiparams").is_file()


def test_save_without_layer_raises(tmp_path):
    with pytest.raises(TypeError, match="Layer"):
        static.save_inference_model(str(tmp_path / "m"), [], None, None)
    with pytest.raises(TypeError, match="feed_vars"):
        static.save_inference_model(str(tmp_path / "m"), [], None, None,
                                    program=torch.nn.Linear(2, 2))


@pytest.mark.parametrize("model", ["bert", "llama"])
def test_exported_model_matches_the_reference_and_keeps_the_kernel(tmp_path, model):
    """Tiny BERT with a key-padding mask (K1 with segment ids) and tiny
    Llama (causal K1, GQA): the port's Predictor against the reference's,
    bit for bit against the live port model, one flash_fwd node a layer
    and no attention traced into plain math, one trace for two runs."""
    if model == "bert":
        jm, tm = _bert_pair()
        inputs = list(_bert_batch())
        layers = tbert.BertConfig.tiny().num_hidden_layers
    else:
        paddle.seed(7)
        cfg = dict(num_key_value_heads=2)
        jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
        tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
        load_reference_state(tm, _state(jm))
        jm.eval()
        inputs = [np.random.default_rng(2).integers(1, 256, (2, 16)).astype(np.int32)]
        layers = tllama.LlamaConfig.tiny().num_hidden_layers
    jinference.export(jm, str(tmp_path / "j"), inputs)
    want = jinference.Predictor(str(tmp_path / "j")).run(inputs)[0]
    inference.export(tm, str(tmp_path / "t"), inputs)
    pred = inference.Predictor(str(tmp_path / "t"), device="cpu")
    got = pred.run(inputs)[0]
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        live = tm(*(torch.from_numpy(a) for a in inputs))
    assert np.array_equal(got, live.numpy())
    assert np.array_equal(pred.run(inputs)[0], got) and pred.trace_count == 1
    assert _flash_nodes(pred) == (layers, [])


def test_jit_save_then_jit_load_in_a_fresh_process(tmp_path):
    """jit.save with InputSpecs, then jit.load in a process that imports
    the port alone: the same outputs bit for bit, and neither jax nor
    paddle_tpu imported there."""
    _, tm = _bert_pair()
    ids, mask = _bert_batch(3)
    prefix = str(tmp_path / "bert")
    jit.save(tm, prefix, input_spec=[jit.InputSpec(list(ids.shape), "int32")] * 2)
    np.save(tmp_path / "ids.npy", ids)
    np.save(tmp_path / "mask.npy", mask)
    code = (
        "import sys, json, numpy as np\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from paddle_tpu_torch import jit\n"
        f"p = jit.load({prefix!r}, device='cpu')\n"
        f"out = p.run([np.load({str(tmp_path / 'ids.npy')!r}), "
        f"np.load({str(tmp_path / 'mask.npy')!r})])\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out[0])\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('jax', 'paddle_tpu'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    with torch.no_grad():
        live = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.array_equal(np.load(tmp_path / "out.npy"), live)


def test_jit_save_pins_dynamic_dims_with_a_warning(tmp_path, caplog):
    _, tm = _mlp_pair()
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch"):
        jit.save(tm, str(tmp_path / "m"), input_spec=[jit.InputSpec([None, 4])])
    assert "pinned to 1" in caplog.text
    pred = jit.load(str(tmp_path / "m"), device="cpu")
    assert isinstance(pred, inference.Predictor)
    x = _x()[:1]
    with torch.no_grad():
        assert np.array_equal(pred.run([x])[0], tm(torch.from_numpy(x)).numpy())
    with pytest.raises(ValueError):
        pred.run([_x()])  # shape-specialized: batch 1 only


def test_weights_only_save_and_load_both_ways(tmp_path, caplog):
    """Without an input_spec only the weights are saved (.pdparams, a
    warning); jit.load returns the state dict, the reference's file too."""
    jm, tm = _mlp_pair()
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch"):
        jit.save(tm, str(tmp_path / "t"))
    assert "weights only" in caplog.text
    assert not (tmp_path / "t.pt2").exists()
    loaded = jit.load(str(tmp_path / "t"))
    assert loaded.keys() == tm.state_dict().keys()
    assert all(torch.equal(loaded[k], v) for k, v in tm.state_dict().items())
    jjit.save(jm, str(tmp_path / "j"))
    ref = jit.load(str(tmp_path / "j"))
    for k, v in _state(jm).items():
        assert np.array_equal(ref[k].numpy(), v)


def test_jit_save_of_a_bound_static_function_and_refusals(tmp_path):
    """A bound StaticFunction exports the decorated function (not the
    Layer's forward) with the owning Layer's weights; a bare callable is
    refused with the reference's TypeError."""
    _, tm = _mlp_pair()

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp = tm

        def head(self, x):
            return self.mlp(x) * 2.0

    net = Net()
    sf = jit.to_static(net.head)
    jit.save(sf, str(tmp_path / "h"), input_spec=[jit.InputSpec([2, 4])])
    x = _x()
    with torch.no_grad():
        want = net.head(torch.from_numpy(x)).numpy()
    assert np.array_equal(jit.load(str(tmp_path / "h"), device="cpu").run([x])[0], want)
    from paddle_tpu_torch.framework import io

    saved = io.load(str(tmp_path / "h.pdiparams"))
    assert saved.keys() == net.state_dict().keys()
    with pytest.raises(TypeError, match="Layer"):
        jit.save(lambda x: x, str(tmp_path / "f"), input_spec=[jit.InputSpec([2])])
    with pytest.raises(TypeError, match="Layer"):
        jit.save(lambda x: x, str(tmp_path / "f"))


def test_predictor_device_and_config(tmp_path, monkeypatch):
    """The card unless asked: without CUDA the default Predictor raises
    naming device='cpu'; Config.disable_gpu() or device='cpu' runs on the
    CPU; the names are the reference's x{i} / y{i}."""
    _, tm = _mlp_pair()
    inference.export(tm, str(tmp_path / "m"), [_x()])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.Predictor(str(tmp_path / "m"))
    config = inference.Config(str(tmp_path / "m"))
    config.set_cpu_math_library_num_threads(2)
    config.switch_ir_optim(False)
    config.disable_gpu()
    pred = inference.create_predictor(config)
    assert pred.device.type == "cpu" and not config.use_gpu()
    assert pred.get_input_names() == ["x0"] and pred.get_output_names() == ["y0"]
    with pytest.raises(ValueError, match="takes 1 inputs"):
        pred.run([_x(), _x()])


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_serve_predict_and_health(tmp_path):
    """`serve` of an exported program: /predict against the reference's
    Predictor.run (1e-5) and the port's (bit for bit), inputs cast to the
    traced dtypes (float64 JSON numbers), /health, a bad body's 400 "Type:
    message", the reference's 404 for /generate, and the SIGTERM handler
    it installed on the main thread put back at stop."""
    import signal

    jm, tm = _mlp_pair()
    x = _x()
    jinference.export(jm, str(tmp_path / "j"), [x])
    want = jinference.Predictor(str(tmp_path / "j")).run([x])[0]
    inference.export(tm, str(tmp_path / "t"), [x])
    pred = inference.Predictor(str(tmp_path / "t"), device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    server = inference.serve(pred, port=0, block=False)
    assert signal.getsignal(signal.SIGTERM) is not before
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        code, body = _post(f"{url}/predict", {"inputs": [x.tolist()]})
        assert code == 200
        served = np.asarray(body["outputs"][0], np.float32)
        np.testing.assert_allclose(served, want, **TOL)
        assert np.array_equal(served, pred.run([x])[0])
        with urllib.request.urlopen(f"{url}/health", timeout=10) as r:
            assert r.status == 200 and json.loads(r.read())["status"] == "ok"
        code, body = _post(f"{url}/predict", {"inputs": [[1.0, 2.0]]})
        assert code == 400 and body["error"].startswith("ValueError: ")
        code, body = _post(f"{url}/generate", {"input_ids": [1, 2]})
        assert code == 404 and "/predict" in body["error"]
    finally:
        server.stop()
    assert signal.getsignal(signal.SIGTERM) is before


def test_serve_from_a_path_and_predict_without_a_program(tmp_path, monkeypatch):
    """`serve(<path>)` loads the program itself (on the card unless the
    device is the CPU's); a server without an exported program answers
    /predict with the reference's 404."""
    from paddle_tpu_torch.inference import GenerationPredictor

    _, tm = _mlp_pair()
    x = _x()
    inference.export(tm, str(tmp_path / "t"), [x])
    class OnTheCpu(inference.Predictor):
        def __init__(self, path):
            super().__init__(path, device="cpu")

    monkeypatch.setattr(inference, "Predictor", OnTheCpu)
    server = inference.serve(str(tmp_path / "t"), port=0, block=False,
                             handle_signals=False)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        code, body = _post(f"{url}/predict", {"inputs": [x.tolist()]})
        with torch.no_grad():
            want = tm(torch.from_numpy(x)).numpy()
        assert code == 200 and np.array_equal(np.asarray(body["outputs"][0], np.float32),
                                              want)
    finally:
        server.stop()
    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    server = inference.serve(GenerationPredictor(model), port=0, block=False,
                             handle_signals=False)
    try:
        code, body = _post(f"http://127.0.0.1:{server.server_address[1]}/predict",
                           {"inputs": [x.tolist()]})
        assert code == 404 and "/predict" in body["error"]
    finally:
        server.stop()

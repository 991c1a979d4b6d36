"""Guards of the PyTorch/CUDA port.

- `paddle_tpu_torch` (and `chip_smoke.py`) import neither `jax` nor
  anything of `paddle_tpu`: the port keeps its own copy of what it needs
  (its LoRA package `paddle_tpu_torch.lora` included).
- Entry points default to the CUDA card and raise, rather than run on the
  CPU, when CUDA is absent (the DataLoader's device prefetch too, unless
  given device="cpu").
- `chip_smoke.py` fails, and prints no result, without CUDA or outside a
  checkout.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import _build

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = pathlib.Path(paddle_tpu_torch.__file__).resolve().parent


def _forbidden_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "paddle_tpu"):
                bad.append(f"{path.name}:{node.lineno} imports {name}")
    return bad


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_imports_no_jax_and_no_reference_package(path):
    assert _forbidden_imports(path) == []


def test_guard_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("import jax.numpy as jnp\nfrom paddle_tpu.ops import flash_attention\n"
                 "from paddle_tpu_torch.ops import flash_attention\n")
    assert len(_forbidden_imports(f)) == 2


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(model, max_len=32, prefill_buckets=[8])


def test_adapter_arena_defaults_to_the_card(monkeypatch):
    from paddle_tpu_torch.lora import AdapterArena, AdapterRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = AdapterRegistry(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdapterArena(reg, capacity=2)
    arena = AdapterArena(reg, capacity=2, device="cpu")
    assert arena._rows.device.type == "cpu"


def test_lora_serving_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "from paddle_tpu_torch.lora import AdapterArena, make_random\n"
            "from paddle_tpu_torch.inference.paging import SessionStore\n"
            "from paddle_tpu_torch.inference import serve\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_disaggregated_serving_imports_neither_jax_nor_the_reference():
    """The handoff's wire format, the roles and the /reserve and /prefill
    hops, with no `jax`, `paddle_tpu` or `ml_dtypes` (bfloat16 rows cross
    as their bits)."""
    code = ("import sys\n"
            "from paddle_tpu_torch.inference.paging import (HANDOFF_VERSION, "
            "HandoffFormatError, serialize_kv_handoff, deserialize_kv_handoff)\n"
            "from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine\n"
            "from paddle_tpu_torch.inference import serve\n"
            "from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM\n"
            "import torch\n"
            "m = LlamaForCausalLM(LlamaConfig.tiny(), device='cpu', dtype='bfloat16')\n"
            "kw = dict(device='cpu', slots=1, max_len=32, prefill_buckets=[8], page_size=8)\n"
            "pre = ContinuousBatchingEngine(m, role='prefill', **kw)\n"
            "dec = ContinuousBatchingEngine(m, role='decode', **kw)\n"
            "h = pre.submit([1, 2, 3], max_new_tokens=1, export_kv=True)\n"
            "pre.run_until_idle()\n"
            "assert h.kv_export['dtype'] == 'bfloat16'\n"
            "r = dec.submit([1, 2, 3], max_new_tokens=2, handoff=h.kv_export)\n"
            "dec.run_until_idle()\n"
            "assert r.wait(1).tolist()[3] == h.tokens[0]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_device_prefetch_raises_without_cuda_unless_cpu(monkeypatch):
    from paddle_tpu_torch import io

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = io.TensorDataset([torch.arange(8)])
    for depth in (True, 2):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            io.DataLoader(data, batch_size=4, prefetch_to_device=depth)
    loader = io.DataLoader(data, batch_size=4, prefetch_to_device=2, device="cpu")
    assert [b[0].tolist() for b in loader] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    io.DataLoader(data, batch_size=4)  # no prefetch stage: no device needed


def test_training_loop_imports_neither_jax_nor_the_reference():
    code = ("import sys, paddle_tpu_torch as p\n"
            "from paddle_tpu_torch import io, metric, hapi, callbacks, fault\n"
            "from paddle_tpu_torch.callbacks import EarlyStopping\n"
            "from paddle_tpu_torch.distributed import checkpoint\n"
            "from paddle_tpu_torch.fault import heartbeat\n"
            "assert p.Model is hapi.Model and p.save and p.load\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_kernel_build_targets_hopper_and_needs_nvcc(monkeypatch):
    assert [p.name for p in _build.sources()] == [
        "flash_bwd.cu", "flash_fwd.cu", "graph_cond.cu", "optim.cu", "paged_decode.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.relative_to(ROOT) == pathlib.Path("build/paddle_tpu_torch")
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def _c_exports():
    """{name: (return type, [parameter types])} of every `extern "C"`
    function in csrc/*.cu, read from the source."""
    import re

    found = {}
    for src in _build.sources():
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for ret, name, params in re.findall(
                r'extern "C"\s+([\w\s\*]+?)\s*(\w+)\s*\(([^)]*)\)', text):
            types = [re.sub(r"\s*\b\w+$", "", p.strip()).replace("const ", "")
                     for p in params.split(",") if p.strip()]
            found[name] = (ret.replace("const ", "").strip(), types)
    return found


def test_ctypes_signatures_match_the_c_exports():
    """Python's argtypes and the C prototypes agree parameter by parameter:
    a mismatch would pass garbage to a kernel on the card."""
    import ctypes

    c_to_ctypes = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
                   "float": ctypes.c_float, "char*": ctypes.c_char_p}
    exports = _c_exports()
    assert sorted(exports) == sorted(_build.SIGNATURES)
    for name, (argtypes, restype) in _build.SIGNATURES.items():
        ret, params = exports[name]
        assert [c_to_ctypes[p.replace(" ", "")] for p in params] == argtypes, name
        assert c_to_ctypes[ret.replace(" ", "")] == restype, name


def _c_parameter_names(name):
    """Parameter names of one `extern "C"` function in csrc/*.cu."""
    import re

    for src in _build.sources():
        text = re.sub(r"//[^\n]*", "", src.read_text())
        found = re.search(r'extern "C"[\w\s\*]+?\b' + name + r"\s*\(([^)]*)\)", text)
        if found:
            return [p.strip().split()[-1].lstrip("*")
                    for p in found.group(1).split(",")]
    raise AssertionError(f"{name} not found")


@pytest.mark.parametrize("name, before, choice", [
    ("ptt_paged_decode", "splits", "path"),
    ("ptt_paged_decode_q8", "splits", "path"),
    ("ptt_paged_decode_partials", "splits", "path"),
    ("ptt_paged_decode_partials_q8", "splits", "path"),
    ("ptt_paged_decode_cp", "splits", "path"),
    ("ptt_paged_decode_cp_q8", "splits", "path"),
    ("ptt_flash_fwd", "dtype", "path"),
    ("ptt_dense_decode", "dtype", "path"),
    ("ptt_flash_bwd", "dtype", "path"),
    ("ptt_flash_fwd_ring", "dtype", "path"),
    ("ptt_flash_bwd_ring", "dtype", "path"),
])
def test_entry_points_take_the_hosts_kernel_choice(name, before, choice):
    """Each entry point behind a dispatch rule (`paged_path`, `flash_path`)
    takes the host's choice as the int the wrappers pass it in."""
    import ctypes

    names = _c_parameter_names(name)
    assert names[names.index(before) + 1] == choice
    assert _build.SIGNATURES[name][0][names.index(choice)] is ctypes.c_int


def _run_chip_smoke(script, cwd):
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    proc = _run_chip_smoke(ROOT / "chip_smoke.py", ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = _run_chip_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_the_serving_fleet_and_the_launcher_load_no_jax_and_no_reference():
    """Importing every module of the serving fleet and of
    `distributed.launch` in a fresh interpreter loads neither `jax` nor any
    module of `paddle_tpu`."""
    code = ("import sys\n"
            "import paddle_tpu_torch.serving as s\n"
            "from paddle_tpu_torch.serving import autoscaler, journal, replica, router, "
            "workload\n"
            "from paddle_tpu_torch.distributed.launch import main\n"
            "[getattr(s, n) for n in s.__all__]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_replica_worker_without_a_card_raises(monkeypatch):
    """The worker serves on the card unless `--device cpu` asks for the
    CPU: with no CUDA it raises before building a model."""
    from paddle_tpu_torch.serving import replica

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replica.main(["--port", "1"])

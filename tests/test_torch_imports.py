"""Guards of the PyTorch/CUDA port.

- `paddle_tpu_torch` (and `chip_smoke.py`) import neither `jax` nor
  anything of `paddle_tpu`: the port keeps its own copy of what it needs.
- Entry points default to the CUDA card and raise, rather than run on the
  CPU, when CUDA is absent.
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


def test_kernel_build_targets_hopper_and_needs_nvcc(monkeypatch):
    assert [p.name for p in _build.sources()] == ["flash_fwd.cu", "paged_decode.cu"]
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

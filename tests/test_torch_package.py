"""The port's package rules: paddle_tpu_torch and chip_smoke.py import
neither jax nor paddle_tpu, entry points run on ``cuda`` unless asked for
the CPU and never fall back to it, and the flag registry keeps the
reference's semantics."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.generator import default_generator
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, \
    opt_state_from_jax
from paddle_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(mod):
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="paddle_tpu_torch."))


def test_importing_every_module_loads_no_jax_and_no_paddle_tpu():
    mods = _all_modules()
    assert {"paddle_tpu_torch.models.gpt", "paddle_tpu_torch.amp.auto_cast",
            "paddle_tpu_torch.optimizer.optimizer",
            "paddle_tpu_torch.distributed.spmd",
            "paddle_tpu_torch.nn.functional.loss"} <= set(mods)
    code =("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import paddle_tpu_torch\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'paddle_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'paddle_tpu.')))\n"
            "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "ab_forward.py", "ab_kernels.py", "nms_routes.py",
       "paged_variants.py", "tf32_variants.py"]))
def test_source_imports_no_jax_and_no_paddle_tpu(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_every_module_names_the_file_it_ports():
    for mod in _all_modules():
        path = PKG.joinpath(*mod.split(".")[1:])
        path = path / "__init__.py" if path.is_dir() else \
            path.with_suffix(".py")
        doc = ast.get_docstring(ast.parse(path.read_text()))
        assert doc, f"{mod} has no docstring"
        if path.name != "__init__.py" and path.parent.name != "testing":
            assert "paddle_tpu/" in doc, f"{mod} names no reference file"


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(GPTConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_generator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        opt_state_from_jax({"__step__": np.int32(1)})
    assert opt_state_from_jax({"__step__": np.int32(1)},
                              device="cpu")["__step__"].device.type == "cpu"
    m = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    assert m.device.type == "cpu"
    out = m.eval().generate(torch.zeros((1, 3), dtype=torch.long),
                            max_new_tokens=2, temperature=0.0)
    assert out.shape == (1, 5)


def test_resolve_device_refuses_other_devices():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_seed_reseeds_the_default_generators():
    pt.seed(3)
    a = torch.randn(4, generator=default_generator("cpu"))
    pt.seed(3)
    b = torch.randn(4, generator=default_generator("cpu"))
    assert torch.equal(a, b)


def test_model_weights_follow_the_generator():
    cfg = GPTConfig.tiny()
    a = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    b = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    c = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    wa, wb, wc = (m.gpt.blocks[0].attn.qkv.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    ln = a.gpt.blocks[0].ln1
    assert torch.equal(ln.weight, torch.ones(64))
    assert torch.equal(a.gpt.blocks[0].mlp.fc1.bias, torch.zeros(256))
    # Xavier-normal: std sqrt(2 / (fan_in + fan_out))
    std = a.gpt.wte.weight.std().item()
    assert abs(std - (2.0 / (1024 + 64)) ** 0.5) < 0.01


class TestFlags:
    def test_defaults(self):
        assert pt.get_flag("tpp_kernels") is False
        assert pt.get_flag("flash_attention_block") == 0
        assert pt.get_flags(["FLAGS_tpp_kernels", "missing"]) == {
            "FLAGS_tpp_kernels": False}

    def test_conflicting_default_raises_same_default_does_not(self):
        flags.define_flag("_test_flag_a", 1, "a test flag")
        flags.define_flag("_test_flag_a", 1)
        with pytest.raises(ValueError, match="conflicting defaults"):
            flags.define_flag("_test_flag_a", 2)

    def test_set_before_define_is_adopted(self):
        pt.set_flags({"FLAGS__test_flag_b": 7})
        assert flags.define_flag("_test_flag_b", 3, "later definition") == 7
        assert pt.get_flag("_test_flag_b") == 7

    def test_env_seeds_by_default_type(self, monkeypatch):
        monkeypatch.setenv("FLAGS__test_flag_c", "true")
        assert flags.define_flag("_test_flag_c", False) is True


def test_build_lists_the_kernel_sources(monkeypatch, tmp_path):
    assert _build.sources() == ["flash_bwd", "flash_fwd", "nms",
                                "paged_attention", "tpp_matmul",
                                "tpp_rowwise"]
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(FileNotFoundError):
        _build.build(["no_such_kernel"])


def test_build_hash_covers_every_included_header(monkeypatch, tmp_path):
    """An edit to a header a source includes, directly or through another
    header, names a new library: a stale one is never loaded."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [h.name for h in _build._local_headers(tmp_path / "k.cu")] == \
        ["a.cuh", "b.cuh"]
    before = _build._target("k")[1]
    (tmp_path / "b.cuh").write_text("// two\n")
    assert _build._target("k")[1] != before
    assert _build._target("k")[1] == _build._target("k")[1]


def test_ptxas_report_reads_registers_and_spills(monkeypatch):
    log = ("ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1kv\n"
           "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z1jv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1jv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 40 registers, used 0 barriers\n")
    monkeypatch.setattr(_build, "build_log", lambda name: log)
    assert _build.ptxas_report("k") == {
        "_Z1kv": {"registers": 128, "spill_bytes": 8},
        "_Z1jv": {"registers": 40, "spill_bytes": 0}}


def test_sass_counts_tell_the_tf32_mma_apart(monkeypatch, tmp_path):
    """sass_counts counts every HMMA, and under "HMMA.TF32" those on TF32
    operands (the fp32 backward pair's), from cuobjdump's listing."""
    so = tmp_path / "k.so"
    so.write_bytes(b"")
    sass = ("        /*0a30*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;\n"
            "        /*0a40*/  HMMA.1688.F32.TF32 R0, R8, R14, R0 ;\n"
            "        /*0a50*/  HMMA.16816.F32.BF16 R16, R20, R24, R16 ;\n"
            "        /*0a60*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4] ;\n")
    monkeypatch.setattr(_build, "_target", lambda name: (None, so))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, sass, ""))
    assert _build.sass_counts("k") == {"HGMMA": 1, "HMMA": 3,
                                       "HMMA.TF32": 2}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("nvcc is installed here")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_fwd"])


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

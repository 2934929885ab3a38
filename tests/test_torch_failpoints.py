"""The port's fault-injection framework (paddle_tpu_torch/testing/
failpoints.py) against the JAX package's: the same site table, the same
specs accepted and rejected, and arm / hits / scoped / error:N / transform
behaving the same. Host-side code only: every comparison is exact."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paddle_tpu.testing import failpoints as jfp  # noqa: E402

from paddle_tpu_torch import flags as pflags  # noqa: E402
from paddle_tpu_torch.testing import failpoints as pfp  # noqa: E402

SPECS = [
    "ckpt/write=error", "ckpt/write=error:2", "serving/step=delay:5",
    "serving/step=delay:0.5", "trainer/batch=scale:2",
    "trainer/batch=scale:nan", "serving/slot=kill",
    " ckpt/read = error:1 , serving/adapter=delay:1 ", "", ",,",
    "ckpt/write=error:0", "ckpt/write=error:x", "ckpt/write=delay",
    "ckpt/write=delay:-1", "ckpt/write=scale", "ckpt/write=boom",
    "no/such=error", "ckpt/write", "ckpt/write=", "=error",
    "stage/run=error", "elastic/resume=delay:3",
]


@pytest.fixture(autouse=True)
def _clean():
    pfp.reset()
    jfp.reset()
    yield
    pfp.reset()
    jfp.reset()


def _parse(mod, spec):
    try:
        return {s: a.spec() for s, a in mod.parse(spec).items()}
    except ValueError:
        return "rejected"


def test_same_site_table():
    assert pfp.SITES.keys() == jfp.SITES.keys()


@pytest.mark.parametrize("spec", SPECS)
def test_parse_accepts_and_rejects_as_the_reference(spec):
    assert _parse(pfp, spec) == _parse(jfp, spec)


def _drive(mod):
    """One arm / fire / scoped sequence; returns what it observed."""
    seen = []
    mod.arm("ckpt/write", "error:2")
    seen.append(mod.armed())
    for _ in range(3):
        try:
            mod.failpoint("ckpt/write")
            seen.append("ok")
        except mod.FailpointError:
            seen.append("raised")
    seen.append((mod.hits("ckpt/write"), mod.armed(), mod.is_enabled()))
    with mod.scoped("serving/slot=error:1,serving/step=delay:0"):
        seen.append(mod.armed())
        mod.failpoint("serving/step")
        try:
            mod.failpoint("serving/slot")
        except mod.FailpointError:
            seen.append("slot raised")
        mod.failpoint("serving/slot")
    seen.append((mod.armed(), mod.hits("serving/slot"),
                 mod.hits("serving/step")))
    with pytest.raises(ValueError):
        mod.arm("ckpt/wrte", "error")
    mod.arm("trainer/batch", "scale:3")
    mod.failpoint("trainer/batch")         # scale acts through transform
    seen.append(mod.hits("trainer/batch"))
    mod.disarm("trainer/batch")
    seen.append(mod.is_enabled())
    return seen


def test_arm_hits_scoped_behave_as_the_reference():
    assert _drive(pfp) == _drive(jfp)


def test_transform_scales_float_tensors_only():
    ids = torch.arange(6).reshape(2, 3)
    x = torch.tensor([1.0, -2.0], dtype=torch.bfloat16)
    arr = np.array([0.5, 4.0], np.float32)
    assert pfp.transform("trainer/batch", [ids, x])[1] is x   # disarmed
    with pfp.scoped("trainer/batch=scale:2"):
        out = pfp.transform("trainer/batch", [ids, x, arr])
    assert out[0] is ids
    assert out[1].dtype == torch.bfloat16
    assert torch.equal(out[1], torch.tensor([2.0, -4.0],
                                            dtype=torch.bfloat16))
    assert np.array_equal(out[2], arr * 2)
    assert pfp.hits("trainer/batch") == 1
    with pfp.scoped("trainer/batch=scale:nan"):
        out = pfp.transform("trainer/batch", (ids, x))
    assert isinstance(out, tuple) and torch.isnan(out[1]).all()
    with pfp.scoped("trainer/batch=error:1"):
        with pytest.raises(pfp.FailpointError):
            pfp.transform("trainer/batch", [x])


def test_arm_from_flag():
    try:
        pflags.set_flags({"failpoints": "ckpt/read=error:1"})
        pfp.arm_from_flag()
        assert pfp.armed() == {"ckpt/read": "error:1"}
        pflags.set_flags({"failpoints": "bogus=error"})
        with pytest.raises(ValueError, match="unknown failpoint site"):
            pfp.arm_from_flag()
    finally:
        pflags.set_flags({"failpoints": ""})
        pfp.arm_from_flag()
    assert not pfp.is_enabled()

"""The port's PP-YOLOE serving path (paddle_tpu_torch/vision/,
paddle_tpu_torch/nn/) against the JAX package's.

The narrow detector of paddle_tpu_torch/testing/golden.py (ppyoloe_tiny,
batch 2, 128 x 128, numpy weights and BatchNorm statistics under the JAX
package's names) runs through both packages. The JAX run is one
``paddle.jit.to_static`` program of forward, decode and postprocess (as
bench.py calls it), compiled once per module. Tolerances
(golden.DET_HEAD_TOL, DET_DECODE_TOL; the reasons are there): head
outputs within 1e-4 in fp32 (the convolutions sum in another order);
decoded boxes and scores within 5e-5 given the same head outputs (exp,
log1p and sigmoid differ in the last bit between XLA and torch);
``multiclass_nms`` given the same decoded boxes and scores exactly equal.
Detections reached from the images are compared for the same labels,
order and padding, and values within DET_OUT_TOL, after checking that
the run is well posed (``golden.check_well_posed``).

Run ``python tests/test_torch_ppyolo.py --write-fixture`` to rewrite the
committed fixture (chip_smoke.py's narrow-detector phase);
test_committed_fixture_matches_jax checks it still matches.
"""
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision.models.ppyolo import ppyoloe_tiny as jax_tiny

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import ppyoloe_params_from_jax
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import BatchNorm2D, Conv2D
from paddle_tpu_torch.ops import nms_pallas
from paddle_tpu_torch.testing import golden
from paddle_tpu_torch.vision import ops
from paddle_tpu_torch.vision.models import PPYOLOE, ppyoloe_tiny

DET_OUT_TOL = golden.DET_OUT_TOL
POST = dict(score_threshold=golden.DET_SCORE_THRESHOLD,
            keep_top_k=golden.DET_KEEP_TOP_K)


def _jax_model(state):
    jm = jax_tiny(num_classes=golden.DET_CLASSES)
    for name, t in jm.state_dict().items():
        t.set_value(state[name])
    jm.eval()
    return jm


def _jax_golden(jm):
    """The JAX package's head outputs (cls_0..2, reg_0..2), decoded boxes
    and scores, and multiclass_nms output and counts for the narrow
    detector `jm`, as numpy arrays."""

    def run(im):
        outs = jm(im)
        boxes, scores = jm.decode(outs)
        out, valid = jm.postprocess(outs, **POST)
        return tuple(c for c, _ in outs) + tuple(r for _, r in outs) \
            + (boxes, scores, out, valid)

    res = [np.asarray(t._data) for t in paddle.jit.to_static(run)(
        paddle.to_tensor(golden.detector_images()))]
    names = [f"cls_{i}" for i in range(3)] + [f"reg_{i}" for i in range(3)] \
        + ["boxes", "scores", "out", "valid"]
    return dict(zip(names, res))


@pytest.fixture(scope="module")
def jax_model():
    """The JAX narrow detector (building it compiles the reference's
    initializers: ~17 s the first time in a process)."""
    return _jax_model(golden.detector_state())


@pytest.fixture(scope="module")
def jax_ref(jax_model):
    return _jax_golden(jax_model)


@pytest.fixture(scope="module")
def port():
    m = ppyoloe_tiny(num_classes=golden.DET_CLASSES, device="cpu")
    m.load_state_dict(ppyoloe_params_from_jax(golden.detector_state()))
    return m.eval()


def _heads(ref):
    return [(torch.from_numpy(ref[f"cls_{i}"].copy()),
             torch.from_numpy(ref[f"reg_{i}"].copy())) for i in range(3)]


def _assert_heads(outs, ref, tol):
    for i, (c, r) in enumerate(outs):
        assert c.dtype == torch.float32 and r.dtype == torch.float32
        np.testing.assert_allclose(c.numpy(), ref[f"cls_{i}"], atol=tol,
                                   rtol=0)
        np.testing.assert_allclose(r.numpy(), ref[f"reg_{i}"], atol=tol,
                                   rtol=0)


def test_auto_cast_leaves_the_detector_in_fp32(port, jax_model, jax_ref):
    """The reference's auto_cast casts only linear/matmul inputs, so its
    convolutions stay fp32 (checked here on the JAX side too); the port's
    conv2d runs with torch's autocast off to match. Without that opt-out
    torch's autocast would hand every convolution bf16."""
    images = golden.detector_images()
    with paddle.amp.auto_cast(True, dtype="bfloat16"):
        jouts = paddle.jit.to_static(lambda im: jax_model(im))(
            paddle.to_tensor(images))
    jref = {}
    for i, (c, r) in enumerate(jouts):
        assert str(c.dtype) == "float32" and str(r.dtype) == "float32"
        jref[f"cls_{i}"], jref[f"reg_{i}"] = np.asarray(c._data), \
            np.asarray(r._data)
    x = torch.from_numpy(images)
    with torch.no_grad():
        plain = port(x)
        with pt.amp.auto_cast(True, dtype="bfloat16"):
            outs = port(x)
            out, valid = port.postprocess(outs, **POST)
    _assert_heads(outs, jref, golden.DET_HEAD_TOL)
    for (c, r), (pc, pr) in zip(outs, plain):
        assert torch.equal(c, pc) and torch.equal(r, pr)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), jax_ref["valid"])


def test_params_from_jax_round_trip(port, jax_model):
    state = {n: np.asarray(t._data) for n, t in
             jax_model.state_dict().items()}
    assert len(state) == 202
    converted = ppyoloe_params_from_jax(state)
    assert set(converted) == set(port.state_dict())
    for name, t in port.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), state[name])
        assert converted[name].shape == t.shape
    assert sum(n.endswith(("._mean", "._variance")) for n in state) == 2 * sum(
        isinstance(m, BatchNorm2D) for m in port.modules())


def test_head_outputs_match_jax_fp32(port, jax_ref):
    with torch.no_grad():
        outs = port(torch.from_numpy(golden.detector_images()))
    _assert_heads(outs, jax_ref, golden.DET_HEAD_TOL)


def test_decode_given_jax_head_outputs(port, jax_ref):
    boxes, scores = port.decode(_heads(jax_ref))
    np.testing.assert_allclose(boxes.numpy(), jax_ref["boxes"],
                               atol=golden.DET_DECODE_TOL, rtol=0)
    np.testing.assert_allclose(scores.numpy(), jax_ref["scores"],
                               atol=golden.DET_DECODE_TOL, rtol=0)


def test_multiclass_nms_given_jax_decode_is_exact(jax_ref):
    out, valid = ops.multiclass_nms(
        torch.from_numpy(jax_ref["boxes"].copy()),
        torch.from_numpy(jax_ref["scores"].copy()),
        nms_threshold=golden.DET_NMS_THRESHOLD, background_label=-1, **POST)
    np.testing.assert_array_equal(out.numpy(), jax_ref["out"])
    np.testing.assert_array_equal(valid.numpy(), jax_ref["valid"])


def test_postprocess_given_jax_head_outputs(port, jax_ref):
    golden.check_well_posed(golden.detection_margins(
        jax_ref["boxes"], jax_ref["scores"], jax_ref["out"]))
    out, valid = port.postprocess(_heads(jax_ref), **POST)
    ok, err = golden.same_detections(out, jax_ref["out"],
                                     golden.DET_DECODE_TOL)
    assert ok, err
    np.testing.assert_array_equal(valid.numpy(), jax_ref["valid"])


def test_whole_slice_from_images_to_detections(port, jax_ref):
    """Images -> forward -> decode -> multiclass NMS on the port, against
    the JAX package, with suppression in the run; well posed first."""
    with torch.no_grad():
        outs = port(torch.from_numpy(golden.detector_images()))
        boxes, scores = port.decode(outs)
        out, valid = port.postprocess(outs, **POST)
    golden.check_well_posed(golden.detection_margins(boxes, scores, out))
    ok, err = golden.same_detections(out, jax_ref["out"], DET_OUT_TOL)
    assert ok, err
    np.testing.assert_array_equal(valid.numpy(), jax_ref["valid"])
    assert out.shape == (golden.DET_BATCH, golden.DET_KEEP_TOP_K, 6)
    candidates = int((scores > golden.DET_SCORE_THRESHOLD).sum())
    assert 0 < int(valid.sum()) < candidates          # NMS suppressed some


def test_committed_fixture_matches_jax(jax_ref):
    fix = np.load(golden.DET_FIXTURE)
    assert set(fix.files) == set(jax_ref)
    for name in jax_ref:
        if name in ("out", "valid"):
            np.testing.assert_array_equal(fix[name], jax_ref[name])
        else:
            np.testing.assert_allclose(fix[name], jax_ref[name], atol=1e-5,
                                       rtol=0)


def test_port_matches_committed_fixture_on_cpu(port):
    """chip_smoke.py's narrow-detector check, on the CPU."""
    fix = np.load(golden.DET_FIXTURE)
    with torch.no_grad():
        outs = port(torch.from_numpy(golden.detector_images()))
        out, valid = port.postprocess(outs, **POST)
    _assert_heads(outs, fix, golden.DET_HEAD_TOL)
    ok, err = golden.same_detections(out, fix["out"], DET_OUT_TOL)
    assert ok, err
    np.testing.assert_array_equal(valid.numpy(), fix["valid"])


# ---- the layers and functionals on the path --------------------------------

@pytest.mark.parametrize("stride,padding,groups,bias", [
    (1, 1, 1, True), (2, 1, 1, False), (1, 0, 2, True), (2, (1, 0), 1, True)])
def test_conv2d_matches_jax(stride, padding, groups, bias):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 9, 10).astype(np.float32)
    w = rng.randn(6, 4 // groups, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32) if bias else None
    want = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                     None if b is None else paddle.to_tensor(b), stride,
                     padding, groups=groups)
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   None if b is None else torch.from_numpy(b), stride,
                   padding, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               atol=1e-5, rtol=0)


def test_conv2d_promotes_a_mixed_pair_like_the_reference():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 2, 5, 5).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 2, 3, 3).astype(np.float32))
    out = F.conv2d(x.to(torch.bfloat16), w, padding=1)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, F.conv2d(x.to(torch.bfloat16).float(), w,
                                             padding=1))
    with pt.amp.auto_cast(True, dtype="bfloat16"):
        assert F.conv2d(x, w, padding=1).dtype == torch.float32


def test_batch_norm_eval_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 4, 3).astype(np.float32)
    mean, var = rng.randn(5).astype(np.float32), \
        rng.uniform(0.5, 1.5, 5).astype(np.float32)
    w, b = rng.randn(5).astype(np.float32), rng.randn(5).astype(np.float32)
    want = JF.batch_norm(paddle.to_tensor(x), paddle.to_tensor(mean),
                         paddle.to_tensor(var), paddle.to_tensor(w),
                         paddle.to_tensor(b))
    got = F.batch_norm(*(torch.from_numpy(a) for a in (x, mean, var, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               atol=1e-5, rtol=0)
    # bf16 x with fp32 statistics promotes to fp32, as jnp does
    half = F.batch_norm(torch.from_numpy(x).to(torch.bfloat16),
                        *(torch.from_numpy(a) for a in (mean, var, w, b)))
    assert half.dtype == torch.float32


def test_batch_statistics_are_not_ported():
    """Batch statistics are ported: in training mode the layer normalises
    by the batch's mean and biased variance and updates its running
    statistics as the JAX package's BatchNorm2D does (momentum 0.9); in
    eval mode it normalises by the running statistics."""
    x = np.random.RandomState(4).randn(2, 3, 4, 4).astype(np.float32) + 1.0
    jbn = paddle.nn.BatchNorm2D(3)
    jbn.train()
    want = np.asarray(jbn(paddle.to_tensor(x))._data)
    bn = BatchNorm2D(3)
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(bn, name).numpy(), np.asarray(
            getattr(jbn, name)._data), atol=1e-6, rtol=0)
    bn = BatchNorm2D(3)
    bn.eval()
    assert torch.equal(bn(torch.ones(1, 3, 2, 2)),
                       torch.ones(1, 3, 2, 2) / torch.sqrt(torch.tensor(
                           1.0 + 1e-5)))


@pytest.mark.parametrize("scale", [2, 3])
def test_interpolate_nearest_matches_jax(scale):
    x = np.random.RandomState(3).randn(2, 3, 4, 5).astype(np.float32)
    want = JF.interpolate(paddle.to_tensor(x), scale_factor=scale,
                          mode="nearest")
    got = F.interpolate(torch.from_numpy(x), scale_factor=scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


@pytest.mark.parametrize("kw", [dict(mode="bilinear", scale_factor=2),
                                dict(size=(8, 8)), dict(scale_factor=1.5)])
def test_interpolate_other_modes_raise(kw):
    with pytest.raises(NotImplementedError):
        F.interpolate(torch.zeros(1, 1, 4, 4), **kw)


@pytest.mark.parametrize("name", ["sigmoid", "silu", "softplus"])
def test_activations_match_jax(name):
    x = np.linspace(-30, 30, 2001).astype(np.float32)
    want = getattr(JF, name)(paddle.to_tensor(x))
    got = getattr(F, name)(torch.from_numpy(x))
    # torch's exp/log1p round the last bit unlike XLA's: ~1 ulp of |x|
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               atol=4e-6, rtol=1e-6)


def test_layers_take_the_reference_names_and_layouts():
    conv = Conv2D(4, 6, 3, padding=1, groups=2)
    assert dict(conv.named_parameters()).keys() == {"weight", "bias"}
    assert conv.weight.shape == (6, 2, 3, 3)
    assert Conv2D(4, 6, 1, bias_attr=False).bias is None
    bn = BatchNorm2D(6)
    assert set(bn.state_dict()) == {"weight", "bias", "_mean", "_variance"}


def test_size_not_a_multiple_of_32_raises(port):
    with pytest.raises(ValueError, match="multiples of 32"):
        port(torch.zeros(1, 3, 100, 128))


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPYOLOE(num_classes=4, width=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppyoloe_tiny()


def test_cpu_path_launches_no_kernel(port):
    nms_pallas.launches.clear()
    with torch.no_grad():
        port.postprocess(port(torch.from_numpy(golden.detector_images())),
                         **POST)
    assert sum(nms_pallas.launches.values()) == 0


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit("usage: python tests/test_torch_ppyolo.py --write-fixture")
    import jax

    jax.config.update("jax_platforms", "cpu")
    golden.DET_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    ref = _jax_golden(_jax_model(golden.detector_state()))
    golden.check_well_posed(golden.detection_margins(
        ref["boxes"], ref["scores"], ref["out"]))
    np.savez_compressed(golden.DET_FIXTURE, **ref)
    print(f"wrote {golden.DET_FIXTURE}")

"""The narrow models whose JAX-package outputs are committed as fixtures:
a GPT, a PP-YOLOE detector, and (see "ResNet, LeNet and BERT" below)
three training runs of a narrow ResNet, LeNet and a tiny BERT.

``chip_smoke.py`` runs the port's eval forward and greedy ``generate`` of
this model on the card and holds them against
``fixtures/gpt_narrow_seq1024.npz``, which holds the JAX package's outputs
for the same weights and ids (tests/test_torch_gpt.py regenerates them
from the JAX package and checks the committed file still matches; run
``python tests/test_torch_gpt.py --write-fixture`` to rewrite it). It also
trains the model for TRAIN_STEPS AdamW steps (lr TRAIN_LR, fresh state,
the next-token labels of ``train_labels``) in fp32 and under bf16
``auto_cast`` and holds the losses and the parameter slices of
``kept_rows`` against ``fixtures/gpt_narrow_train_seq1024.npz``, the JAX
package's SpmdTrainer run of the same steps (``python
tests/test_torch_trainer.py --write-train-fixture`` rewrites it;
tests/test_torch_trainer.py checks it still matches).

Weights and ids come from a numpy seed, in the JAX package's layout
(Linear weights [in, out]) and under its parameter names, so both
packages load the same numbers: the JAX model through ``set_value``, the
port through ``models.convert.params_from_jax``.

The narrow detector is ``ppyoloe_tiny`` (80 classes, width 16, depth 1)
at batch DET_BATCH, DET_SIZE x DET_SIZE, its weights and BatchNorm
statistics drawn by ``detector_state`` and its images by
``detector_images``; ``fixtures/ppyoloe_tiny_128.npz`` holds the JAX
package's head outputs, decoded boxes and scores and its
``multiclass_nms`` output and counts at bench.py's ``score_threshold``
and ``keep_top_k`` (``python tests/test_torch_ppyolo.py --write-fixture``
rewrites it; tests/test_torch_ppyolo.py checks it still matches). The
seed is one whose detections are well posed at DET_HEAD_TOL
(``detection_margins``), and the detections include suppressed boxes.
"""
from pathlib import Path

import numpy as np

#: vocab 512, hidden 128, 2 layers, 2 heads (head_dim 64), seq 1024: the
#: smallest model whose eval forward at 1 x 1024 reaches the flash kernel
NARROW = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=1024, dropout=0.0)
SEED = 0
SEQ = 1024
LOGIT_ROWS = 8       # the last rows of the 1 x 1024 logits kept
PROMPT = 64          # greedy generate: the first 64 ids as the prompt
NEW_TOKENS = 32
FIXTURE = Path(__file__).resolve().parent / "fixtures" / \
    "gpt_narrow_seq1024.npz"
TRAIN_FIXTURE = FIXTURE.with_name("gpt_narrow_train_seq1024.npz")
TRAIN_STEPS = 3
TRAIN_LR = 1e-4
#: parameters whose first KEPT_ROWS rows (JAX layout) the train fixture keeps
KEPT_PARAMS = ("gpt.wte.weight", "gpt.blocks.0.attn.qkv.weight",
               "gpt.blocks.0.attn.qkv.bias", "gpt.blocks.0.ln1.weight",
               "gpt.blocks.1.mlp.fc1.weight", "gpt.blocks.1.mlp.fc2.bias",
               "gpt.ln_f.bias")
KEPT_ROWS = 4
#: limit of update_rel_err for a bf16 auto_cast run against the JAX
#: package's. bf16 rounds at different places in the two packages, and
#: Adam's normalised step turns a rounding-sized grad difference into an
#: lr-sized step wherever a grad is near zero: the port's plain versions
#: read 0.032 on the CPU, as far as the JAX package's own bf16 run lies
#: from its fp32 run (0.030). A backward whose dQ is zero reads 0.36, one
#: whose dK and dV are zero 0.52 (tests/test_torch_trainer.py holds both).
TRAIN_BF16_UPDATE_RTOL = 0.1


#: the pretraining recipe on the narrow model (chip_smoke.py's
#: gpt_narrow_recipe_vs_jax_fixture): AdamW (lr from the schedule, weight
#: decay 0.01) under LinearWarmup(CosineAnnealingDecay(RECIPE_LR,
#: T_max=RECIPE_STEPS), warmup_steps=RECIPE_WARMUP, start_lr=0,
#: end_lr=RECIPE_LR), ClipGradByGlobalNorm(RECIPE_CLIP), SpmdTrainer with
#: accumulate_steps=RECIPE_ACCUM and recompute=True, RECIPE_STEPS steps on
#: one RECIPE_BATCH x SEQ batch (recipe_batch), in fp32 and under bf16
#: auto_cast. ``python tests/test_torch_recipe.py --write-fixture``
#: rewrites the fixture from the JAX package's trainer;
#: test_committed_recipe_fixture_matches_jax checks that it still matches.
RECIPE_FIXTURE = FIXTURE.with_name("gpt_narrow_recipe_seq1024.npz")
RECIPE_STEPS = 4
RECIPE_LR = 1e-3
RECIPE_WARMUP = 2
RECIPE_BATCH = 2
RECIPE_ACCUM = 2
#: below the narrow model's global grad norm at every step of the run
#: (the fixture keeps the JAX package's norms; its test asserts each
#: exceeds this), so that the clip binds at every step
RECIPE_CLIP = 0.25


def recipe_schedule():
    """The recipe's learning-rate schedule, in the port."""
    from ..optimizer.lr import CosineAnnealingDecay, LinearWarmup

    return LinearWarmup(CosineAnnealingDecay(RECIPE_LR, T_max=RECIPE_STEPS),
                        warmup_steps=RECIPE_WARMUP, start_lr=0.0,
                        end_lr=RECIPE_LR)


def recipe_batch(seed=SEED, cfg=NARROW):
    """([RECIPE_BATCH, SEQ] int32 ids, their next-token labels: the ids
    shifted left by one, the last label wrapping to the row's first id)."""
    rng = np.random.RandomState(seed + 2)
    ids = rng.randint(0, cfg["vocab_size"], (RECIPE_BATCH, SEQ)).astype(
        np.int32)
    return ids, np.roll(ids, -1, axis=1)


def param_shapes(cfg=NARROW):
    """{name: shape} of GPTForCausalLM's parameters in the JAX layout."""
    h, v, t = cfg["hidden_size"], cfg["vocab_size"], cfg["max_seq_len"]
    shapes = {"gpt.wte.weight": (v, h), "gpt.wpe.weight": (t, h)}
    for i in range(cfg["num_layers"]):
        pre = f"gpt.blocks.{i}."
        shapes.update({
            pre + "ln1.weight": (h,), pre + "ln1.bias": (h,),
            pre + "attn.qkv.weight": (h, 3 * h), pre + "attn.qkv.bias": (3 * h,),
            pre + "attn.proj.weight": (h, h), pre + "attn.proj.bias": (h,),
            pre + "ln2.weight": (h,), pre + "ln2.bias": (h,),
            pre + "mlp.fc1.weight": (h, 4 * h), pre + "mlp.fc1.bias": (4 * h,),
            pre + "mlp.fc2.weight": (4 * h, h), pre + "mlp.fc2.bias": (h,),
        })
    shapes.update({"gpt.ln_f.weight": (h,), "gpt.ln_f.bias": (h,)})
    return shapes


def jax_layout_params(seed=SEED, cfg=NARROW):
    """{name: float32 array}: normal weights (std 0.02), LayerNorm weights
    near 1, small biases, drawn in param_shapes() order."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("ln1.weight") or name.endswith("ln2.weight") \
                or name.endswith("ln_f.weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.02 * rng.standard_normal(shape)
        out[name] = a.astype(np.float32)
    return out


def input_ids(seed=SEED, cfg=NARROW):
    """[1, SEQ] int32 ids."""
    rng = np.random.RandomState(seed + 1)
    return rng.randint(0, cfg["vocab_size"], (1, SEQ)).astype(np.int32)


def train_labels(seed=SEED, cfg=NARROW):
    """[1, SEQ] int32 next-token labels of ``input_ids``: the ids shifted
    left by one, the last label wrapping to the first id."""
    return np.roll(input_ids(seed, cfg), -1, axis=1)


def kept_rows(named):
    """{name: the first KEPT_ROWS rows of each KEPT_PARAMS parameter} from
    {name: array in the JAX layout (Linear weights [in, out])}."""
    return {n: np.asarray(named[n])[:KEPT_ROWS] for n in KEPT_PARAMS}


def update_rel_err(rows, want_rows):
    """||Δrows - Δwant|| / ||Δwant|| over the kept rows: Δ is a run's
    kept_rows minus those of the initial weights (jax_layout_params()),
    the L2 norms taken over every kept value together. `rows` is
    {name: array}; `want_rows` is {name: array} under the same names."""
    init = kept_rows(jax_layout_params())
    num = sum(float(np.square(np.asarray(rows[n], np.float64)
                              - np.asarray(want_rows[n], np.float64)).sum())
              for n in KEPT_PARAMS)
    den = sum(float(np.square(np.asarray(want_rows[n], np.float64)
                              - init[n].astype(np.float64)).sum())
              for n in KEPT_PARAMS)
    return (num / den) ** 0.5


def port_kept_rows(params):
    """kept_rows of the port's parameters {name: tensor}, in the JAX
    layout (a Linear weight [out, in] is read through its transpose)."""
    from ..models.convert import _LINEAR_WEIGHT

    out = {}
    for n in KEPT_PARAMS:
        t = params[n].detach().float().cpu()
        if _LINEAR_WEIGHT.search(n):
            t = t.t()
        out[n] = t[:KEPT_ROWS].numpy()
    return out


# ---- the narrow detector ----------------------------------------------------

DET_SEED = 83
DET_IMAGE_SEED = 1
DET_BATCH = 2
DET_SIZE = 128
DET_CLASSES = 80
DET_SCORE_THRESHOLD = 0.3      # bench.py:561
DET_KEEP_TOP_K = 100
DET_NMS_THRESHOLD = 0.5        # PPYOLOE.postprocess's default
DET_FIXTURE = FIXTURE.with_name("ppyoloe_tiny_128.npz")
DET_CLS_BIAS = -7.5   # few anchors score above 0.3
DET_BOX_BIAS = 2.0    # boxes of tens of pixels, which overlap
#: head outputs of the port against the JAX package's, fp32 (|x| up to
#: ~14): the convolutions sum in another order (XLA's against oneDNN's on
#: the CPU, cuDNN's on the card). The CPU reads ~6e-6 against the JAX
#: package's compiled run, which itself lies 6e-6 from its eager run.
#: Detections are compared exactly where every score lies more than 10x
#: this from the score threshold and from its neighbour in the output, and
#: every IoU that NMS decides on more than 10x this from the IoU threshold.
DET_HEAD_TOL = 1e-4
#: decoded boxes and scores given the same head outputs: the two
#: libraries' exp, log1p and sigmoid round the last bit differently
#: (softplus of an fp32 input differs by up to 4.8e-7 absolute at |x| ~
#: 16 on the CPU); boxes reach ~200 px, where an fp32 ulp is 1.5e-5.
DET_DECODE_TOL = 5e-5
#: detections reached from the images: boxes are pixels, a head difference
#: scaled by a stride of up to 32 (3.2e-3) plus the decode's last bits
DET_OUT_TOL = 5e-3


def detector_shapes():
    """{name: shape} of ppyoloe_tiny's state dict (parameters and
    BatchNorm buffers; the names and layouts of both packages)."""
    from ..vision.models import ppyoloe_tiny

    return {n: tuple(t.shape) for n, t in
            ppyoloe_tiny(device="cpu").state_dict().items()}


def detector_state(seed=DET_SEED):
    """{name: float32 array}: conv weights N(0, 2/fan_in), the 1x1
    prediction convs N(0, 144/fan_in) with biases near DET_CLS_BIAS and
    DET_BOX_BIAS, BatchNorm weights near 1, biases near 0,
    _mean ~ N(0, 0.1) and _variance ~ U(0.5, 1.5), so that no BatchNorm is
    the identity. Drawn in detector_shapes() order."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in detector_shapes().items():
        if name.endswith("._mean"):
            a = 0.1 * rng.standard_normal(shape)
        elif name.endswith("._variance"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("bn.weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bn.bias"):
            a = 0.1 * rng.standard_normal(shape)
        elif "_preds." in name and name.endswith(".bias"):
            a = (DET_CLS_BIAS if "cls_preds" in name else DET_BOX_BIAS) \
                + 0.1 * rng.standard_normal(shape)
        else:
            gain = 12.0 if "_preds." in name else np.sqrt(2.0)
            a = rng.standard_normal(shape) * gain \
                / np.sqrt(np.prod(shape[1:]))
        out[name] = a.astype(np.float32)
    return out


def detector_images(seed=DET_IMAGE_SEED):
    """[DET_BATCH, 3, DET_SIZE, DET_SIZE] float32 in [0, 1)."""
    return np.random.RandomState(seed).rand(
        DET_BATCH, 3, DET_SIZE, DET_SIZE).astype(np.float32)


def _iou(a, b):
    """IoU of xyxy boxes a [n, 4] against b [m, 4], in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    area = lambda x: np.maximum(x[:, 2] - x[:, 0], 0) \
        * np.maximum(x[:, 3] - x[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter,
                              1e-9)


def detection_margins(boxes, scores, out, score_threshold=DET_SCORE_THRESHOLD,
                      iou_threshold=DET_NMS_THRESHOLD):
    """How far multiclass_nms's decisions lie from flipping, given decoded
    boxes [B, A, 4], scores [B, C, A] and its output [B, K, 6]: the least
    distance of any score from score_threshold, of any kept score from the
    next kept score of its image, and of the IoU of any two boxes of one
    image and class that both pass score_threshold (only those can
    suppress each other) from iou_threshold. None where there is no such
    pair."""
    boxes, scores, out = (np.asarray(t) for t in (boxes, scores, out))
    m = {"score_vs_threshold": float(np.abs(scores - score_threshold).min()),
         "kept_score_gap": None, "iou_vs_threshold": None}
    for i in range(out.shape[0]):
        kept = out[i, :, 1][out[i, :, 1] > 0]
        if len(kept) > 1:
            gap = float(np.abs(np.diff(kept)).min())
            m["kept_score_gap"] = min(gap, m["kept_score_gap"] or gap)
        for c in range(scores.shape[1]):
            idx = np.nonzero(scores[i, c] > score_threshold)[0]
            if len(idx) > 1:
                iou = _iou(boxes[i, idx], boxes[i, idx])
                d = float(np.abs(iou[np.triu_indices(len(idx), 1)]
                                 - iou_threshold).min())
                m["iou_vs_threshold"] = min(d, m["iou_vs_threshold"] or d)
    return m


def check_well_posed(margins, tol=DET_HEAD_TOL):
    """Raise unless every margin of detection_margins exceeds 10 x tol."""
    bad = {k: v for k, v in margins.items()
           if v is not None and v <= 10 * tol}
    if bad:
        raise ValueError(f"detections are not well posed at tolerance {tol}:"
                         f" {bad} (choose another DET_SEED)")


def same_detections(got, want, tol):
    """Whether two multiclass_nms outputs [B, K, 6] hold the same
    detections: the same padded rows, labels and order, with scores and
    boxes within tol. Returns (bool, the largest value difference)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return False, float("inf")
    pad_g, pad_w = got[..., 1] < 0, want[..., 1] < 0
    if not np.array_equal(pad_g, pad_w) \
            or not np.array_equal(got[..., 0], want[..., 0]):
        return False, float("inf")
    err = float(np.abs(got - want).max())
    return err <= tol, err


# ---- the narrow detector's training fixture ---------------------------------

#: the JAX package's SpmdTrainer run of DET_TRAIN_STEPS Momentum steps of
#: the narrow detector (detector_state, detector_images, the targets of
#: detector_targets), as bench.py trains PP-YOLOE (:493-545):
#: loss(decode(model(x))) with Momentum(lr 0.01, momentum 0.9) under bf16
#: auto_cast, which casts nothing on the detector. ``python
#: tests/test_torch_ppyolo_train.py --write-fixture`` rewrites it.
DET_TRAIN_FIXTURE = FIXTURE.with_name("ppyoloe_tiny_train_128.npz")
DET_TRAIN_STEPS = 3
DET_TRAIN_LR = 0.01
DET_TRAIN_MOMENTUM = 0.9
DET_TARGET_SEED = 1            # bench.py:529's RandomState(1)
DET_STRIDES = (8, 16, 32)
#: the first this many values of each parameter and velocity (flattened)
#: are kept whole; every other value enters through its tensor's norm
DET_KEPT_VALUES = 64
#: a run against the fixture, fp32 throughout (the reference's auto_cast
#: casts nothing on the detector): the losses and every kept value
#: (parameters, velocities, running statistics) within this of
#: max(1, max |kept fixture values|) of its tensor; the convolutions'
#: grads sum in another order (oneDNN's or cuDNN's against XLA's), and
#: three Momentum steps at lr 0.01 carry that into the weights, the
#: velocities and the next steps' statistics. The CPU reads 9.2e-5 (a
#: velocity); about 10x that allows the card's other sums.
DET_TRAIN_RTOL = 1e-3
#: each tensor's update and velocity norm, relative: the CPU reads 5.1e-4
#: (a BatchNorm bias's update norm)
DET_TRAIN_NORM_RTOL = 5e-3


def detector_targets(batch=DET_BATCH, size=DET_SIZE, seed=DET_TARGET_SEED,
                     num_classes=DET_CLASSES):
    """(gt_boxes [batch, A, 4] float32 pixels, gt_labels [batch, A] int64
    in [0, num_classes], num_classes being background), drawn as bench.py
    draws them (:528-533) over the A anchors of the three strides."""
    A = sum((size // s) ** 2 for s in DET_STRIDES)
    rng = np.random.RandomState(seed)
    gt_boxes = (rng.rand(batch, A, 4) * size).astype(np.float32)
    gt_labels = rng.randint(0, num_classes + 1, (batch, A)).astype(np.int64)
    return gt_boxes, gt_labels


def detector_train_summary(losses, params, velocities, buffers, init):
    """What the training fixture keeps of a run, from numpy arrays keyed by
    the trainer's names: the losses; each parameter's first
    DET_KEPT_VALUES values and the norm of its update (from `init`); each
    velocity's first values and norm; every buffer (the BatchNorm running
    statistics) whole."""
    out = {"loss": np.asarray(losses, np.float32)}
    for n, p in params.items():
        p = np.asarray(p, np.float32).ravel()
        v = np.asarray(velocities[n], np.float32).ravel()
        d = p.astype(np.float64) - np.asarray(init[n], np.float64).ravel()
        out[f"kept__{n}"] = p[:DET_KEPT_VALUES]
        out[f"update_norm__{n}"] = np.float64(np.linalg.norm(d))
        out[f"velocity__{n}"] = v[:DET_KEPT_VALUES]
        out[f"velocity_norm__{n}"] = np.float64(
            np.linalg.norm(v.astype(np.float64)))
    for n, b in buffers.items():
        out[f"buffer__{n}"] = np.asarray(b, np.float32)
    return out


def detector_train_errors(got, want):
    """{"loss", "values", "norms"}: the largest relative differences of the
    summary `got` from `want` (losses relative to each loss, kept values
    to max(1, max |want|) of their tensor, norms to the norm)."""
    if set(got) != set(want):
        raise ValueError(f"summaries differ in keys: "
                         f"{sorted(set(got) ^ set(want))[:4]}")
    err = {"loss": float(np.max(np.abs(got["loss"] / want["loss"] - 1))),
           "values": 0.0, "norms": 0.0}
    for key, w in want.items():
        g = np.asarray(got[key], np.float64)
        w = np.asarray(w, np.float64)
        if key.startswith(("kept__", "velocity__", "buffer__")):
            e = float(np.max(np.abs(g - w))) / max(1.0, float(np.abs(w).max()))
            err["values"] = max(err["values"], e)
        elif key.startswith(("update_norm__", "velocity_norm__")):
            e = float(abs(g - w) / max(float(w), 1e-12))
            err["norms"] = max(err["norms"], e)
    return err


def detector_train_step(det, loss_fn):
    """The layer the trainer drives: ``loss_fn(det.decode(det(x)),
    (gt_boxes, gt_labels))``, bench.py's TrainStep (:511-521), over the
    port's detector and loss."""
    from torch import nn

    class TrainStep(nn.Module):
        def __init__(self):
            super().__init__()
            self.det = det
            self.det_loss = loss_fn

        def forward(self, x, gt_boxes, gt_labels):
            return self.det_loss(self.det.decode(self.det(x)),
                                 (gt_boxes, gt_labels))

    return TrainStep()


# ---- ResNet, LeNet and BERT: three training steps each ----------------------

#: the JAX package's runs of MODEL_TRAIN_STEPS steps of three narrow models,
#: each as bench.py trains the full one, from the weights of jax_state and
#: the batches below: ``ResNet(BottleneckBlock, depth=18,
#: num_classes=10)`` (resnet50's block and code with two blocks a stage,
#: as the JAX package's three steps of resnet50 and its build take ~27 s
#: of this CPU's test budget) at RESNET_BATCH x 3 x
#: RESNET_SIZE^2 through SpmdTrainer with Momentum and CrossEntropyLoss
#: under bf16 auto_cast (bench.py:357-392); LeNet through
#: ``Model.prepare(Adam(1e-3), CrossEntropyLoss())`` and ``train_batch``
#: (:446-470); ``BertConfig.tiny()`` at BERT_BATCH x BERT_SEQ through
#: SpmdTrainer with AdamW(1e-4) and BertPretrainLoss under bf16 auto_cast
#: (:397-443). ``python tests/test_torch_resnet.py --write-fixture``,
#: ``tests/test_torch_hapi.py`` and ``tests/test_torch_bert.py`` rewrite
#: them; each file's test_committed_*_fixture_matches_jax checks that its
#: fixture still matches a fresh run.
MODEL_TRAIN_STEPS = 3
RESNET_FIXTURE = FIXTURE.with_name("resnet_bottleneck18_train_64.npz")
RESNET_DEPTH = 18
RESNET_SEED = 5
RESNET_CLASSES = 10
RESNET_BATCH = 2
#: 64, not 32: at 32 x 32 the last stage is 1 x 1 and its BatchNorm
#: normalises two values a channel to +-1, so the logits hang on the signs
#: of differences and the second step already fits the two images (loss
#: 0 in both packages); at 64 x 64 it normalises eight
RESNET_SIZE = 64
#: bench.py's momentum; the learning rate a hundredth of bench's 0.1, so
#: that the losses stay off zero, where bf16's relative rounding grows
#: (at lr 0.1 the second and third losses read ~1e-4)
RESNET_LR = 0.001
RESNET_MOMENTUM = 0.9
#: the weight of each residual branch's last BatchNorm (``bn3``) is drawn
#: around this, not around 1. At initialisation the grads of a deep
#: BatchNorm network grow with depth: with every BatchNorm weight near 1,
#: resnet50's grads at this batch have a norm of ~2,000 for a loss of
#: 3.2, its fp32 grads lie 1% from an fp64 run overall (up to 15% within
#: a tensor) in both packages, and three steps wander (losses 3.20, 0.91,
#: 2.08 in the JAX package's run at lr 0.01, the two packages' third
#: losses 18% apart even at lr 1e-4): rounding would decide the fixture.
#: With the branches' last BatchNorm near 0.1 (the practice of
#: zero-initialised residual branches, kept off zero so that the branches
#: learn) resnet50's grad norm is ~22 and its fp32 grads lie 3e-6 from
#: fp64 overall.
RESNET_BRANCH_GAMMA = 0.1
LENET_FIXTURE = FIXTURE.with_name("lenet_train_batch8.npz")
LENET_SEED = 6
LENET_BATCH = 8
LENET_LR = 1e-3
BERT_FIXTURE = FIXTURE.with_name("bert_tiny_pretrain_128.npz")
BERT_SEED = 7
BERT_BATCH = 2
BERT_SEQ = 128
BERT_LR = 1e-4
#: the first this many values of each parameter and optimizer slot
#: (flattened) are kept; every value enters through its tensor's norms
MODEL_KEPT_VALUES = 64
#: a run against its fixture (model_train_errors), by key:
#: - loss: each loss relative. Under bf16 auto_cast ResNet's and BERT's
#:   losses are bf16 (the logits' dtype), whose last bit is 2^-8 relative:
#:   two rounding-sized fp32 differences may round to neighbouring bf16
#:   values, so the bands allow two bf16 steps;
#: - updates: sqrt(sum |Δgot - Δwant|^2 / sum |Δwant|^2) over every kept
#:   value (Δ a parameter's change from its initial value): as
#:   update_rel_err for the GPT, Adam's normalised step turns a
#:   rounding-sized grad difference into an lr-sized one where a grad is
#:   near zero;
#: - slots: the same ratio over the kept optimizer slots against the
#:   fixture's (velocity; moment1 and moment2);
#: - norms: the same ratio over every tensor's update norm and slot norms
#:   (a ratio over all of them: a tensor whose grad is rounding alone, as
#:   k_proj's bias in attention, has norms of rounding);
#: - buffers: the BatchNorm running statistics, whole, relative to
#:   max(1, max |fixture|) of their tensor.
#: The port's plain versions on the CPU read, against the fixtures:
#: resnet loss 0, updates 7.6e-3, slots 1.1e-2, norms 2.6e-4, buffers
#: 9.8e-5; lenet (fp32) loss 5.9e-7, updates 3.9e-6, norms 2.3e-6; bert
#: loss 0, updates 3.3e-2, slots 6.0e-3, norms 7.2e-4. The bands allow
#: about three to five times those, for the card's other sums (cuDNN's
#: convolutions, cuBLAS's bf16 products), as the GPT's bf16 band does.
MODEL_TRAIN_TOL = {
    "resnet": {"loss": 2e-2, "updates": 5e-2, "slots": 5e-2, "norms": 1e-2,
               "buffers": 1e-3},
    "lenet": {"loss": 1e-5, "updates": 1e-3, "slots": 1e-3, "norms": 1e-3,
              "buffers": 0.0},
    "bert": {"loss": 2e-2, "updates": 0.1, "slots": 5e-2, "norms": 1e-2,
             "buffers": 0.0},
}


def jax_shapes(model):
    """{name: shape} of a port model's state dict in the JAX package's
    layout (the weights of its Linear layers [in, out])."""
    from ..models.convert import linear_weights

    linear = linear_weights(model)
    return {n: tuple(t.shape)[::-1] if n in linear else tuple(t.shape)
            for n, t in model.state_dict().items()}


def jax_state(shapes, seed, std_2d=None, bias_std=0.1, small=(),
              small_gamma=0.1):
    """{name: float32 array} in `shapes`' order and layout: conv weights
    N(0, 2 / fan_in); 2-D weights N(0, std_2d^2), or N(0, 1 / rows) when
    std_2d is None (a [in, out] Linear's fan-in); other weights (BatchNorm
    and LayerNorm) 1 + N(0, 0.01), or small_gamma (1 + N(0, 0.01)) for
    names ending in one of `small`; biases N(0, bias_std^2); BatchNorm's
    _mean N(0, 0.01) and _variance U(0.5, 1.5), so no norm is the
    identity."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("._mean"):
            a = 0.1 * rng.standard_normal(shape)
        elif name.endswith("._variance"):
            a = rng.uniform(0.5, 1.5, shape)
        elif len(shape) == 4:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif len(shape) == 2:
            std = std_2d if std_2d is not None else 1.0 / np.sqrt(shape[0])
            a = std * rng.standard_normal(shape)
        elif name.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
            if name.endswith(tuple(small)):
                a = small_gamma * a
        else:
            a = bias_std * rng.standard_normal(shape)
        out[name] = a.astype(np.float32)
    return out


def resnet_batch(seed=RESNET_SEED):
    """(images [RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE] float32 in
    [0, 1), labels [RESNET_BATCH] int32), as bench.py draws them."""
    rng = np.random.RandomState(seed + 1)
    images = rng.rand(RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE)
    labels = rng.randint(0, RESNET_CLASSES, (RESNET_BATCH,))
    return images.astype(np.float32), labels.astype(np.int32)


def lenet_batch(seed=LENET_SEED):
    """(images [LENET_BATCH, 1, 28, 28] float32, labels [LENET_BATCH, 1]
    int64), as bench.py draws them."""
    rng = np.random.RandomState(seed + 1)
    images = rng.rand(LENET_BATCH, 1, 28, 28).astype(np.float32)
    return images, rng.randint(0, 10, (LENET_BATCH, 1)).astype(np.int64)


def bert_batch(seed=BERT_SEED, vocab_size=1024):
    """(ids, token types (zeros), MLM labels), each [BERT_BATCH, BERT_SEQ]
    int32, as bench.py draws them."""
    rng = np.random.RandomState(seed + 1)
    ids = rng.randint(0, vocab_size, (BERT_BATCH, BERT_SEQ))
    labels = rng.randint(0, vocab_size, (BERT_BATCH, BERT_SEQ))
    return (ids.astype(np.int32), np.zeros_like(ids, np.int32),
            labels.astype(np.int32))


def model_train_summary(losses, params, init, slots=None, buffers=None):
    """What a model's training fixture keeps of a run, from numpy arrays
    keyed by the JAX package's names and in its layout: the losses; each
    parameter's first MODEL_KEPT_VALUES values, its initial ones and the
    norm of its update; each optimizer slot's (``slots``: {slot: {name:
    array}}) first values and norm; every buffer whole."""
    out = {"loss": np.asarray(losses, np.float32)}
    for n, p in params.items():
        p = np.asarray(p, np.float32).ravel()
        p0 = np.asarray(init[n], np.float32).ravel()
        out[f"kept__{n}"] = p[:MODEL_KEPT_VALUES]
        out[f"init__{n}"] = p0[:MODEL_KEPT_VALUES]
        out[f"update_norm__{n}"] = np.float64(np.linalg.norm(
            p.astype(np.float64) - p0))
    for slot, arrays in (slots or {}).items():
        for n, a in arrays.items():
            a = np.asarray(a, np.float32).ravel()
            out[f"{slot}__{n}"] = a[:MODEL_KEPT_VALUES]
            out[f"{slot}_norm__{n}"] = np.float64(np.linalg.norm(
                a.astype(np.float64)))
    for n, b in (buffers or {}).items():
        out[f"buffer__{n}"] = np.asarray(b, np.float32)
    return out


def model_train_errors(got, want):
    """{"loss", "updates", "slots", "norms", "buffers"} of the summary
    `got` against `want` (see MODEL_TRAIN_TOL)."""
    if set(got) != set(want):
        raise ValueError(f"summaries differ in keys: "
                         f"{sorted(set(got) ^ set(want))[:4]}")
    f64 = lambda k, s: np.asarray(s[k], np.float64)  # noqa: E731
    err = {"loss": float(np.max(np.abs(f64("loss", got) / f64("loss", want)
                                       - 1))), "buffers": 0.0}
    sums = {"updates": [0.0, 0.0], "slots": [0.0, 0.0], "norms": [0.0, 0.0]}

    def add(kind, g, w):
        sums[kind][0] += float(np.square(g - w).sum())
        sums[kind][1] += float(np.square(w).sum())

    for key in want:
        kind, _, name = key.partition("__")
        if kind == "kept":
            add("updates", f64(key, got) - f64(f"init__{name}", got),
                f64(key, want) - f64(f"init__{name}", want))
        elif kind.endswith("_norm"):
            add("norms", f64(key, got), f64(key, want))
        elif kind == "buffer":
            w = f64(key, want)
            e = float(np.abs(f64(key, got) - w).max()) \
                / max(1.0, float(np.abs(w).max()))
            err["buffers"] = max(err["buffers"], e)
        elif kind not in ("loss", "init"):
            add("slots", f64(key, got), f64(key, want))
    for k, (num, den) in sums.items():
        err[k] = (num / den) ** 0.5 if den else 0.0
    return err


def within(err, tol):
    """Whether every error of model_train_errors lies within its band."""
    return all(err[k] <= tol[k] for k in tol)


def jax_layout(tensors, model):
    """{name: numpy array} of the port's tensors {name: tensor} under
    the same names, in the JAX package's layout (the weights of `model`'s
    Linear layers, and their 2-D optimizer slots, transposed)."""
    from ..models.convert import linear_weights

    linear = linear_weights(model)
    out = {}
    for n, t in tensors.items():
        a = t.detach().float().cpu().numpy().copy()
        out[n] = a.T.copy() if n in linear and a.ndim == 2 else a
    return out


def port_train_summary(trainer, model, init, losses, slots):
    """model_train_summary of a port SpmdTrainer's run (`init`: the
    parameters before it, as jax_layout gives them; `slots`: the
    optimizer's slot names to keep)."""
    return model_train_summary(
        losses, jax_layout(trainer.params, model), init,
        {s: jax_layout({n: trainer.opt_state[n][s] for n in trainer.params},
                       model) for s in slots},
        jax_layout(trainer.buffers, model))


def resnet_narrow(device=None):
    """The narrow ResNet of the fixture, in the port."""
    from ..vision.models import BottleneckBlock, ResNet

    return ResNet(BottleneckBlock, RESNET_DEPTH, num_classes=RESNET_CLASSES,
                  device=device)


def resnet_state(model):
    """jax_state of a port ResNet (the names and shapes of both packages),
    its residual branches' last BatchNorm near RESNET_BRANCH_GAMMA."""
    return jax_state(jax_shapes(model), RESNET_SEED, small=("bn3.weight",),
                     small_gamma=RESNET_BRANCH_GAMMA)

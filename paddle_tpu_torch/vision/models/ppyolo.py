"""PP-YOLOE-style anchor-free detector: inference and its training loss.

Ports ``ConvBNLayer``, ``CSPBlock``, ``CSPBackbone``, ``PANNeck``,
``PPYOLOEHead``, ``PPYOLOE`` (``forward``, ``decode``, ``postprocess``),
``PPYOLOELoss`` and ``ppyoloe_tiny`` of paddle_tpu/vision/models/ppyolo.py
(:20-254), NCHW, with the reference's module and parameter names, so
``models.convert.ppyoloe_params_from_jax`` loads the JAX model's
``state_dict()`` unchanged. In eval mode BatchNorm runs on its running
statistics; in training mode on the batch's, updating the running ones
(``nn.functional.batch_norm``). A training step is
``PPYOLOELoss(decode(model(x)), targets)``, as bench.py trains it.

``postprocess`` decodes the head's per-level outputs into boxes and
sigmoid scores and runs ``vision.ops.multiclass_nms`` with no background
class: one NMS kernel launch per call on the card.
"""
import torch
from torch import nn

from ...core.device import resolve_device
from ...nn import functional as F
from ...nn.functional.activation import _softplus
from ...nn.layer import BatchNorm2D, Conv2D, init_weights


class ConvBNLayer(nn.Module):
    def __init__(self, ch_in, ch_out, k=3, stride=1, groups=1, act="silu"):
        super().__init__()
        self.conv = Conv2D(ch_in, ch_out, k, stride=stride, padding=k // 2,
                           groups=groups, bias_attr=False)
        self.bn = BatchNorm2D(ch_out)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return getattr(F, self.act)(x) if self.act else x


class CSPBlock(nn.Module):
    """Cross-stage-partial block: split, residual bottlenecks, merge."""

    def __init__(self, ch, n_bottlenecks=1):
        super().__init__()
        mid = ch // 2
        self.left = ConvBNLayer(ch, mid, k=1)
        self.right = ConvBNLayer(ch, mid, k=1)
        self.blocks = nn.ModuleList([
            nn.Sequential(ConvBNLayer(mid, mid, k=1),
                          ConvBNLayer(mid, mid, k=3))
            for _ in range(n_bottlenecks)])
        self.merge = ConvBNLayer(2 * mid, ch, k=1)

    def forward(self, x):
        left = self.left(x)
        y = self.right(x)
        for blk in self.blocks:
            y = y + blk(y)
        return self.merge(torch.cat([left, y], dim=1))


class CSPBackbone(nn.Module):
    """Stages at strides 8/16/32 -> feature pyramid [C3, C4, C5]."""

    def __init__(self, width=32, depth=1):
        super().__init__()
        w = width
        self.stem = nn.Sequential(ConvBNLayer(3, w, k=3, stride=2),
                                  ConvBNLayer(w, w, k=3, stride=2))
        self.stages = nn.ModuleList()
        chs = [w, 2 * w, 4 * w, 8 * w]
        for i in range(3):
            self.stages.append(nn.Sequential(
                ConvBNLayer(chs[i], chs[i + 1], k=3, stride=2),
                CSPBlock(chs[i + 1], depth)))
        self.out_channels = chs[1:]

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats  # strides 8, 16, 32


class PANNeck(nn.Module):
    """Top-down feature fusion (upsample + lateral 1x1 + CSP merge)."""

    def __init__(self, in_channels):
        super().__init__()
        c3, c4, c5 = in_channels
        self.lat5 = ConvBNLayer(c5, c4, k=1)
        self.merge4 = CSPBlock(c4)
        self.lat4 = ConvBNLayer(c4, c3, k=1)
        self.merge3 = CSPBlock(c3)
        self.out_channels = [c3, c4, c5]

    def forward(self, feats):
        c3, c4, c5 = feats
        p5 = c5
        up5 = F.interpolate(self.lat5(p5), scale_factor=2, mode="nearest")
        p4 = self.merge4(c4 + up5)
        up4 = F.interpolate(self.lat4(p4), scale_factor=2, mode="nearest")
        p3 = self.merge3(c3 + up4)
        return [p3, p4, p5]


class PPYOLOEHead(nn.Module):
    """Decoupled anchor-free head: per level, cls logits [B, C, H, W] and
    box ltrb distances [B, 4, H, W]."""

    def __init__(self, in_channels, num_classes=80):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        for ch in in_channels:
            self.cls_convs.append(ConvBNLayer(ch, ch, k=3))
            self.reg_convs.append(ConvBNLayer(ch, ch, k=3))
            self.cls_preds.append(Conv2D(ch, num_classes, 1))
            self.reg_preds.append(Conv2D(ch, 4, 1))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            cls = self.cls_preds[i](self.cls_convs[i](x))
            reg = self.reg_preds[i](self.reg_convs[i](x))
            outs.append((cls, reg))
        return outs


class PPYOLOE(nn.Module):
    """Compact PP-YOLOE-class detector, strides (8, 16, 32). Runs on
    ``device`` (default ``cuda``; raises without a CUDA device unless
    ``device="cpu"``), with weights drawn from ``generator`` (default: the
    CPU default generator) by the reference's initializers."""

    def __init__(self, num_classes=80, width=32, depth=1, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        with torch.device("meta"):
            self.backbone = CSPBackbone(width, depth)
            self.neck = PANNeck(self.backbone.out_channels)
            self.head = PPYOLOEHead(self.neck.out_channels, num_classes)
        self.to_empty(device="cpu")
        init_weights(self, generator)
        self.to(dev)
        self.num_classes = num_classes
        self.strides = (8, 16, 32)

    @property
    def device(self):
        return self.head.cls_preds[0].weight.device

    def forward(self, images):
        h, w = images.shape[-2], images.shape[-1]
        if h % self.strides[-1] or w % self.strides[-1]:
            raise ValueError(
                f"PPYOLOE input H/W must be multiples of {self.strides[-1]}, "
                f"got {h}x{w} (pad or resize the batch first)")
        return self.head(self.neck(self.backbone(
            torch.as_tensor(images, device=self.device))))

    def decode(self, head_outs):
        """-> (boxes [B, A, 4] xyxy in pixels, scores [B, num_classes, A])."""
        all_boxes, all_scores = [], []
        for (cls, reg), stride in zip(head_outs, self.strides):
            b, c, h, w = cls.shape
            ys = (torch.arange(h, dtype=torch.float32, device=cls.device)
                  + 0.5) * stride
            xs = (torch.arange(w, dtype=torch.float32, device=cls.device)
                  + 0.5) * stride
            cy, cx = torch.meshgrid(ys, xs, indexing="ij")
            # ltrb distances are kept positive by jax.nn.softplus
            l, t, r, btm = [reg[:, i] * stride for i in range(4)]
            x1 = cx[None] - _softplus(l)
            y1 = cy[None] - _softplus(t)
            x2 = cx[None] + _softplus(r)
            y2 = cy[None] + _softplus(btm)
            all_boxes.append(torch.stack([x1, y1, x2, y2], dim=-1)
                             .reshape(b, h * w, 4))
            all_scores.append(torch.sigmoid(cls).reshape(b, c, h * w))
        return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=2)

    def postprocess(self, head_outs, score_threshold=0.05, nms_threshold=0.5,
                    keep_top_k=100):
        """decode + per-class NMS: (out [B, keep_top_k, 6], valid [B])."""
        from ..ops import multiclass_nms

        boxes, scores = self.decode(head_outs)
        # sigmoid scores: every class is foreground (no background column)
        return multiclass_nms(boxes, scores, score_threshold=score_threshold,
                              nms_threshold=nms_threshold,
                              keep_top_k=keep_top_k, background_label=-1)


class PPYOLOELoss(nn.Module):
    """The reference's simplified PP-YOLOE loss over decoded predictions
    (boxes [B, A, 4] xyxy, sigmoid scores [B, C, A]) and per-anchor
    targets (gt_boxes [B, A, 4], gt_labels [B, A], ``num_classes`` for
    background): focal BCE on the scores clipped to [1e-6, 1 - 1e-6], and
    1 - IoU on the positive anchors, each summed and divided by the count
    of positives (at least 1). Maxima split the gradient at ties, as
    jnp.maximum does."""

    def __init__(self, num_classes=80, cls_weight=1.0, iou_weight=2.5):
        super().__init__()
        self.num_classes = num_classes
        self.cls_weight = cls_weight
        self.iou_weight = iou_weight

    def forward(self, decoded, targets):
        boxes, scores = decoded
        gt_b, gt_l = targets
        C = self.num_classes
        gt_l = torch.as_tensor(gt_l, device=boxes.device).long()
        gt_b = torch.as_tensor(gt_b, device=boxes.device)
        pos = gt_l < C                                          # [B, A]
        # background (C) -> an all-zero row
        onehot = torch.nn.functional.one_hot(gt_l, C + 1)[..., :C].float()
        p = torch.clamp(scores.transpose(1, 2), 1e-6, 1 - 1e-6)
        focal = -(onehot * (1 - p) ** 2 * torch.log(p)
                  + (1 - onehot) * p ** 2 * torch.log(1 - p))
        n_pos = pos.sum().clamp_min(1)
        cls_loss = focal.sum() / n_pos

        zero = boxes.new_zeros(())

        def area(b):
            return torch.maximum(b[..., 2] - b[..., 0], zero) \
                * torch.maximum(b[..., 3] - b[..., 1], zero)

        ix1 = torch.maximum(boxes[..., 0], gt_b[..., 0])
        iy1 = torch.maximum(boxes[..., 1], gt_b[..., 1])
        ix2 = torch.minimum(boxes[..., 2], gt_b[..., 2])
        iy2 = torch.minimum(boxes[..., 3], gt_b[..., 3])
        inter = torch.maximum(ix2 - ix1, zero) * torch.maximum(iy2 - iy1,
                                                               zero)
        iou = inter / torch.maximum(area(boxes) + area(gt_b) - inter,
                                    boxes.new_tensor(1e-9))
        iou_loss = ((1 - iou) * pos).sum() / n_pos
        return self.cls_weight * cls_loss + self.iou_weight * iou_loss


def ppyoloe_tiny(num_classes=80, device=None, generator=None):
    return PPYOLOE(num_classes=num_classes, width=16, depth=1, device=device,
                   generator=generator)

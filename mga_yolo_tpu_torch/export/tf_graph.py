"""The port's eval forward as TensorFlow ops, for the TFLite and SavedModel
export (counterpart of ``mga_yolo_tpu/utils/tflite_export.py``
``_eval_forward``, which reaches TensorFlow through ``jax2tf``).

:func:`tf_forward` walks the BN-folded model's graph in ``graph.py``'s order
and emits, for each module class of the port, the TensorFlow ops of its
eval forward on NHWC tensors, the weights taken from the module as
constants. The attention modules' masked reductions, the CAM gate's MLP and
the DFL decode are the math of the kernels' plain versions
(``ops/cam_gate.py`` ``cam_gate_ref``, ``ops/masked_pool.py``
``masked_pool_ref``): the exported graph holds no kernel.

What differs from PyTorch's layout, and what the TFLite converter sees:

* Convs pad explicitly (a ``PAD`` of zeros, then ``VALID``) wherever TF's
  ``SAME`` would pad otherwise: a stride-2 3x3 conv on an even input pads 0
  rows on top and 1 at the bottom under ``SAME``, 1 on each side in
  PyTorch. A stride-1 conv with the symmetric ``k // 2`` padding, and
  SPPF's stride-1 max pools, are ``SAME``, which pads the same rows and, in
  a max pool, never reads the padding: what ``max_pool2d``'s implicit -inf
  padding gives, with no -inf constant in the graph for int8 calibration to
  take a range over.
* The 2x nearest upsample repeats rows and columns (reshape and tile).
* The masked averages' ``max(msum, eps)`` denominators are a real ``DIV``
  and the DFL a real ``SOFTMAX``: the int8 export keeps those two op types
  in float by name (``tflite.py``).
* The input is 0-255 BGR, letterboxed, NHWC; the graph multiplies it by
  1/255 (a ``MUL``, not a ``DIV``: a quantized ``DIV`` traps on a zero
  denominator).

TensorFlow is imported inside the functions: the card's host has none.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from mga_yolo_tpu_torch.models import layers as L
from mga_yolo_tpu_torch.models.attention import MaskCBAM, MaskECA, MaskSPADE, ProbMaskGater
from mga_yolo_tpu_torch.models.heads import Detect, MGAMaskHead
from mga_yolo_tpu_torch.models.yolo import Concat, Upsample
from mga_yolo_tpu_torch.ops.boxes import make_anchors
from mga_yolo_tpu_torch.ops.masked_pool import NEG
from mga_yolo_tpu_torch.utils.model_utils import fuse_model


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _softplus(p: torch.Tensor) -> float:
    return float(torch.nn.functional.softplus(p.detach().float().cpu()))


class _Emitter:
    """TensorFlow ops of the port's modules in eval mode, NHWC."""

    def __init__(self, tf):
        self.tf = tf

    # -- convolutions ------------------------------------------------------

    def conv(self, conv: nn.Conv2d, x, bn: nn.BatchNorm2d | None = None):
        """``conv`` (OIHW; plain or depthwise), then the eval BatchNorm
        ``bn`` folded into its weights, on NHWC ``x``."""
        tf = self.tf
        w = conv.weight.detach().double().cpu()
        b = conv.bias.detach().double().cpu() if conv.bias is not None else torch.zeros(w.shape[0], dtype=w.dtype)
        if bn is not None:
            a = bn.running_var.detach().double().cpu().add(bn.eps).rsqrt()
            if bn.weight is not None:
                a = a * bn.weight.detach().double().cpu()
            shift = -bn.running_mean.detach().double().cpu() * a
            if bn.bias is not None:
                shift = shift + bn.bias.detach().double().cpu()
            w, b = w * a.view(-1, 1, 1, 1), b * a + shift
        (sh, sw), (ph, pw), (dh, dw), g = conv.stride, conv.padding, conv.dilation, conv.groups
        kh, kw = w.shape[2:]
        same = (sh, sw) == (1, 1) and (ph, pw) == (dh * (kh - 1) // 2, dw * (kw - 1) // 2) and kh % 2 and kw % 2
        if not same and (ph or pw):
            x = tf.pad(x, [[0, 0], [ph, ph], [pw, pw], [0, 0]])
        pad = "SAME" if same else "VALID"
        hwio = w.permute(2, 3, 1, 0).float().numpy()       # (kh, kw, c_in / g, c_out)
        c_in, c_out = int(x.shape[-1]), w.shape[0]
        if g == 1:
            y = tf.nn.conv2d(x, hwio, (1, sh, sw, 1), pad, dilations=(1, dh, dw, 1))
        elif g == c_in == c_out:  # depthwise (DWConv): (kh, kw, c, 1)
            y = tf.nn.depthwise_conv2d(x, hwio.reshape(kh, kw, c_in, 1), (1, sh, sw, 1), pad, dilations=(dh, dw))
        else:
            raise ValueError(f"tf_forward: no TensorFlow version of a conv of {g} groups, {c_in} -> {c_out} channels")
        return tf.nn.bias_add(y, b.float().numpy())

    def silu(self, x):
        return x * self.tf.sigmoid(x)

    def conv_bn(self, m: L.ConvBN, x):
        bn = m.bn if isinstance(m.bn, nn.BatchNorm2d) else None
        y = self.conv(m.conv, x, bn)
        return self.silu(y) if isinstance(m.act, nn.SiLU) else y

    def sequential(self, seq: nn.Sequential, x):
        mods = list(seq)
        i = 0
        while i < len(mods):
            m = mods[i]
            if isinstance(m, nn.Conv2d):
                bn = mods[i + 1] if i + 1 < len(mods) and isinstance(mods[i + 1], nn.BatchNorm2d) else None
                x = self.conv(m, x, bn)
                i += 2 if bn is not None else 1
                continue
            x = self.module(m, x)
            i += 1
        return x

    # -- blocks ------------------------------------------------------------

    def bottleneck(self, m: L.Bottleneck, x):
        y = self.conv_bn(m.cv2, self.conv_bn(m.cv1, x))
        return x + y if m.add else y

    def c2f(self, m: L.C2f, x):
        ys = list(self.tf.split(self.conv_bn(m.cv1, x), [m.c, m.c], axis=-1))
        for b in m.m:
            ys.append(self.module(b, ys[-1]))
        return self.conv_bn(m.cv2, self.tf.concat(ys, -1))

    def c3(self, m: L.C3, x):
        a = self.conv_bn(m.cv1, x)
        for b in m.m:
            a = self.bottleneck(b, a)
        return self.conv_bn(m.cv3, self.tf.concat([a, self.conv_bn(m.cv2, x)], -1))

    def sppf(self, m: L.SPPF, x):
        outs = [self.conv_bn(m.cv1, x)]
        for _ in range(3):
            outs.append(self.tf.nn.max_pool2d(outs[-1], m.k, 1, "SAME"))
        return self.conv_bn(m.cv2, self.tf.concat(outs, -1))

    def upsample(self, x):
        """Nearest 2x: each column, then each row, repeated (rank 4 throughout)."""
        tf = self.tf
        B, H, W, C = (int(d) for d in x.shape)
        x = tf.tile(tf.reshape(x, (B * H, W, 1, C)), (1, 1, 2, 1))
        x = tf.tile(tf.reshape(x, (B, H, 1, 2 * W * C)), (1, 1, 2, 1))
        return tf.reshape(x, (B, 2 * H, 2 * W, C))

    def module(self, m: nn.Module, x):
        """A single-input module."""
        if isinstance(m, L.ConvBN):  # DWConv too
            return self.conv_bn(m, x)
        if isinstance(m, L.Bottleneck):
            return self.bottleneck(m, x)
        if isinstance(m, L.C2f):  # C3k2 too
            return self.c2f(m, x)
        if isinstance(m, L.C3):
            return self.c3(m, x)
        if isinstance(m, L.SPPF):
            return self.sppf(m, x)
        if isinstance(m, Upsample):
            return self.upsample(x)
        if isinstance(m, MGAMaskHead):
            return self.conv(m.head, self.sequential(m.proj, x))
        if isinstance(m, nn.Sequential):
            return self.sequential(m, x)
        if isinstance(m, nn.Conv2d):
            return self.conv(m, x)
        if isinstance(m, nn.SiLU):
            return self.silu(x)
        if isinstance(m, nn.ReLU):
            return self.tf.nn.relu(x)
        raise ValueError(f"tf_forward: no TensorFlow version of module {type(m).__name__}")

    # -- mask-guided attention --------------------------------------------

    def _same_hw(self, mod: nn.Module, feat, mask):
        if tuple(mask.shape[1:3]) != tuple(feat.shape[1:3]):
            raise ValueError(f"tf_forward: {type(mod).__name__} mask {tuple(mask.shape)} is not at the features' "
                             f"resolution {tuple(feat.shape)}; the export resizes no mask")

    def _prob(self, mask, use_sigmoid: bool):
        return self.tf.sigmoid(mask) if use_sigmoid else mask

    def gater(self, g: ProbMaskGater, p):
        """Eval mode: p clipped to [0, 1] (and to at least ``p_min``)."""
        p = self.tf.clip_by_value(p, 0.0, 1.0)
        return self.tf.maximum(p, g.p_min) if g.p_min > 0 else p

    def masked_descriptors(self, x, m, tiny_thr: float, eps: float, want_max: bool = True):
        """``pool_f32``: (avg, max) (B, C) of NHWC x under the (B, H, W, 1)
        mask probabilities m, the tiny-mask and no-pixel GAP fallbacks."""
        tf = self.tf
        N = int(x.shape[1]) * int(x.shape[2])
        msum = tf.reduce_sum(m, (1, 2))                                  # (B, 1)
        wsum = tf.reduce_sum(x * m, (1, 2))                              # (B, C)
        gap = tf.reduce_sum(x, (1, 2)) * (1.0 / N)
        mavg = tf.math.divide(wsum, tf.maximum(msum, eps))
        valid = tf.cast(msum * (1.0 / N) >= tiny_thr, tf.float32)
        avg = mavg * valid + gap * (1.0 - valid)
        if not want_max:
            return avg, None
        sel = m > 0.5
        mmax = tf.reduce_max(tf.where(sel, x, NEG), (1, 2))
        cnt = tf.reduce_sum(tf.cast(sel, tf.float32), (1, 2))
        return avg, tf.where(cnt > 0, mmax, gap)

    def linear(self, lin: nn.Linear, d):
        return self.tf.matmul(d, _np(lin.weight).T) + _np(lin.bias)

    def cbam(self, mod: MaskCBAM, feat, mask):
        tf = self.tf
        self._same_hw(mod, feat, mask)
        if mod.gater is not None:
            mask = self.gater(mod.gater, mask)
        prob = self._prob(mask, mod.use_sigmoid_mask)
        avg, mx = self.masked_descriptors(feat, prob, mod.tiny_mask_thr, mod.eps)
        fc1, fc2 = mod.cam_mlp[0], mod.cam_mlp[2]

        def mlp(d):
            return self.linear(fc2, tf.nn.relu(self.linear(fc1, d)))

        gate = tf.sigmoid(mlp(avg) + mlp(mx))
        cam_out = feat * gate[:, None, None, :]
        x_max = tf.reduce_max(cam_out, -1, keepdims=True)
        x_avg = tf.reduce_mean(cam_out, -1, keepdims=True)
        att = self.conv(mod.sam_conv, tf.concat([x_max, x_avg, prob], -1))
        sam_out = cam_out * tf.sigmoid(att)
        return feat + _softplus(mod.beta) * (sam_out - feat)

    def eca(self, mod: MaskECA, feat, mask):
        tf = self.tf
        if mask is None:
            y = tf.reduce_mean(feat, (1, 2))
        else:
            self._same_hw(mod, feat, mask)
            y, _ = self.masked_descriptors(feat, self._prob(mask, mod.use_sigmoid_mask), mod.tiny_mask_thr,
                                           mod.eps, want_max=False)
        # conv1d over the channels: (B, C) as a (B, 1, C, 1) image, k // 2 zeros each side
        k = mod.conv1d.weight.shape[-1]
        p = mod.conv1d.padding[0]
        C = int(y.shape[-1])
        yi = tf.pad(tf.reshape(y, (-1, 1, C, 1)), [[0, 0], [0, 0], [p, p], [0, 0]])
        w = tf.nn.conv2d(yi, _np(mod.conv1d.weight).reshape(1, k, 1, 1), 1, "VALID")
        g = 1.0 + _softplus(mod.beta) * (tf.sigmoid(tf.reshape(w, (-1, C))) - 0.5)
        return feat * g[:, None, None, :]

    def spade(self, mod: MaskSPADE, feat, mask):
        tf = self.tf
        if mod.norm is not None:  # scale- and bias-free BatchNorm, eval
            a = _np(mod.norm.running_var.add(mod.norm.eps).rsqrt())
            x_hat = feat * a + (-_np(mod.norm.running_mean) * a)
        else:  # instance norm over H x W, biased variance
            mu = tf.reduce_mean(feat, (1, 2), keepdims=True)
            d = feat - mu
            x_hat = d * tf.math.rsqrt(tf.reduce_mean(d * d, (1, 2), keepdims=True) + mod.eps)
        if mask is None:
            return x_hat
        self._same_hw(mod, feat, mask)
        h = self.sequential(mod.shared, self._prob(mask, mod.use_sigmoid_mask))
        return self.conv(mod.conv_gamma, h) * x_hat + self.conv(mod.conv_beta, h)

    # -- detection head ----------------------------------------------------

    def detect(self, mod: Detect, xs):
        tf = self.tf
        maps = [tf.concat([self.sequential(mod.cv2[i], x), self.sequential(mod.cv3[i], x)], -1)
                for i, x in enumerate(xs)]
        B = int(maps[0].shape[0])
        r, nc = mod.reg_max, mod.nc
        flat = tf.concat([tf.reshape(m, (B, -1, 4 * r + nc)) for m in maps], 1)     # (B, A, no), rows row-major
        A = int(flat.shape[1])
        box, cls = flat[..., :4 * r], flat[..., 4 * r:]
        prob = tf.nn.softmax(tf.reshape(box, (B * A * 4, r)), axis=-1)
        proj = _np(mod.dfl.conv.weight).reshape(r, 1)
        dist = tf.reshape(tf.matmul(prob, proj), (B, A, 4))
        shapes = [(int(m.shape[1]), int(m.shape[2])) for m in maps]
        anchors, stride = (t.numpy() for t in make_anchors(shapes, mod.strides, 0.5))
        x1y1 = anchors - dist[..., :2]
        x2y2 = anchors + dist[..., 2:]
        dbox = tf.concat([(x1y1 + x2y2) * 0.5, x2y2 - x1y1], -1) * stride
        return tf.concat([dbox, tf.sigmoid(cls)], -1)

    # -- the graph ---------------------------------------------------------

    def model(self, net, images):
        """``MGAModel.forward`` in eval mode: (decoded, {scale: NHWC logits})."""
        spec = net.spec
        save = set(spec.save)
        x = images * (1.0 / 255.0)
        cache, seg = {}, {}
        prev, decoded = x, None
        for node, mod in zip(spec.nodes, net.model):
            ins = [prev if f == node.index - 1 else (x if f < 0 else cache[f]) for f in node.inputs]
            if isinstance(mod, Concat):
                out = self.tf.concat(ins, -1)
            elif isinstance(mod, Detect):
                out = decoded = self.detect(mod, ins)
            elif isinstance(mod, MaskCBAM):
                out = self.cbam(mod, *ins)
            elif isinstance(mod, MaskECA):
                out = self.eca(mod, ins[0], ins[1] if len(ins) > 1 else None)
            elif isinstance(mod, MaskSPADE):
                out = self.spade(mod, ins[0], ins[1] if len(ins) > 1 else None)
            else:
                out = self.module(mod, ins[0])
            if isinstance(mod, MGAMaskHead) and node.scale_name:
                seg[node.scale_name] = out
            if node.index in save:
                cache[node.index] = out
            prev = out
        return decoded, seg


def eval_model(net: nn.Module) -> nn.Module:
    """A float32 eval copy of ``net`` on the CPU with every ConvBN's BN folded."""
    return fuse_model(copy.deepcopy(net).to("cpu", torch.float32).eval())


def tf_forward(net: nn.Module, batch: int, imgsz: int, split_decoded: bool = False):
    """A ``tf.function`` over ``images (batch, imgsz, imgsz, 3) float32``
    (0-255 BGR, letterboxed) computing the eval forward of ``net`` (an
    ``MGAModel``; a BN-folded float32 copy is taken).

    Returns ``(decoded (B, A, 4+nc), *seg)`` with the mask logits NHWC in
    sorted key order (``p3``, ``p4``, ``p5``; none for plain YOLOv8), or
    ``(boxes, scores, *seg)`` with ``split_decoded``: the layout of the JAX
    package's ``_eval_forward``.
    """
    import tensorflow as tf

    net = eval_model(net)
    emit = _Emitter(tf)

    def fwd(images):
        decoded, seg = emit.model(net, images)
        segs = tuple(seg[k] for k in sorted(seg))
        if split_decoded:
            return (decoded[..., :4], decoded[..., 4:]) + segs
        return (decoded,) + segs

    spec = tf.TensorSpec((batch, imgsz, imgsz, 3), tf.float32, name="images")
    return tf.function(fwd, input_signature=[spec], autograph=False)

"""Plain reference of the RMI referring-segmentation model: the DeepLab-v2
ResNet-101 backbone (frozen batch-norm, output stride 8, atrous rates 2 and
4 in the last two groups), the 1x1 visual projection with L2 norm, the
word LSTM, the multimodal LSTM over every feature-map cell (its input
projection factored into a pixel term, a step term and ``h @ W_h``), the
atanh output transform, the 1x1 output projection and the TF1 bilinear
upsample to full size.

"Language-based Colorization of Scene Sketches" (SIGGRAPH Asia 2019) uses
this matcher; its widths are those of ``Instance_Matching/RMI_model.py``.
Leaf names follow the measured program's state dict, so one set of seeded
tensors loads into both.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from . import ops
from .init import Init

FILTERS = (64, 256, 512, 1024, 2048)
NUM_UNITS = (3, 4, 23, 3)
GROUPS = (("group_2", 1, 1), ("group_3", 2, 1), ("group_4", 1, 2),
          ("group_5", 1, 4))          # (name, stride, atrous rate)


class _Node(nn.Module):
    """A named container of leaves."""

    def __init__(self, **leaves):
        super().__init__()
        for name, leaf in leaves.items():
            setattr(self, name, leaf)


def _conv_w(init: Init, k, cin, cout):
    return _Node(DW=init.normal((cout, cin, k, k), (2.0 / (k * k * cout)) ** 0.5))


def _frozen_bn(init: Init, c):
    return _Node(beta=init.const((c,), 0.0), gamma=init.const((c,), 1.0),
                 mean=init.const((c,), 0.0), variance=init.const((c,), 1.0),
                 factor=init.const((1,), 1.0))


class ConvBN(nn.Module):
    def __init__(self, init, k, cin, cout):
        super().__init__()
        self.conv = _conv_w(init, k, cin, cout)
        self.bn = _frozen_bn(init, cout)

    def forward(self, x, stride=1, rate=1):
        b = self.bn
        return ops.frozen_batch_norm(
            ops.conv2d(x, self.conv.DW, stride, rate), b.mean, b.variance,
            b.beta, b.gamma, b.factor)


class Bottleneck(nn.Module):
    def __init__(self, init, cin, cout):
        super().__init__()
        mid = cout // 4
        self.block_1 = ConvBN(init, 1, cin, mid)
        self.block_2 = ConvBN(init, 3, mid, mid)
        self.block_3 = ConvBN(init, 1, mid, cout)
        self.block_add = ConvBN(init, 1, cin, cout) if cin != cout else None

    def forward(self, x, stride, rate):
        y = torch.relu(self.block_1(x, stride, rate))
        y = torch.relu(self.block_2(y, 1, rate))
        y = self.block_3(y, 1, rate)
        skip = x if self.block_add is None else self.block_add(x, stride, rate)
        return torch.relu(y + skip)


class DeepLabV2(nn.Module):
    """images [N, H, W, 3] mean-subtracted -> features [N, H/8, W/8, 2048]."""

    def __init__(self, init: Init):
        super().__init__()
        stem = _Node(conv1=_conv_w(init, 7, 3, FILTERS[0]),
                     bn_conv1=_frozen_bn(init, FILTERS[0]))
        self.group_1 = stem
        for g, (name, _, _) in enumerate(GROUPS):
            for i in range(NUM_UNITS[g]):
                self.add_module(f"{name}_{i}", Bottleneck(
                    init, FILTERS[g] if i == 0 else FILTERS[g + 1],
                    FILTERS[g + 1]))

    def forward(self, images):
        s = self.group_1
        b = s.bn_conv1
        x = ops.conv2d(images, s.conv1.DW, stride=2)
        x = torch.relu(ops.frozen_batch_norm(x, b.mean, b.variance, b.beta,
                                             b.gamma, b.factor))
        x = ops.max_pool_3x3_s2(x)
        for g, (name, stride, rate) in enumerate(GROUPS):
            for i in range(NUM_UNITS[g]):
                x = getattr(self, f"{name}_{i}")(x, stride if i == 0 else 1,
                                                 rate)
        return torch.relu(x)


class Outputs(NamedTuple):
    up: torch.Tensor      # [N, H, W, 1] logits at full size
    pred: torch.Tensor    # [N, h, w, 1] logits at feature size


class RMI(nn.Module):
    """The matcher; ``sizes`` holds the ``MatchingConfig`` fields."""

    def __init__(self, sizes: dict, init: Init):
        super().__init__()
        if sizes.get("fusion_type", "RMI") != "RMI" or sizes.get("use_attn"):
            raise ValueError("the reference covers the default RMI fusion")
        self.sizes = sizes
        v, e, l, m = (sizes["v_emb_dim"], sizes["w_emb_dim"],
                      sizes["w_rnn_size"], sizes["m_rnn_size"])
        self.ResNet = DeepLabV2(init)
        self.text_sketchyscene = _Node(
            visual_feat_projection=_Node(
                DW=init.xavier_conv(v, sizes["vf_dim"], 1),
                biases=init.const((v,), 0.0)),
            embedding=init.uniform((sizes["vocab_size"], e), 0.08),
            wLSTM=_Node(w=init.glorot((e + l, 4 * l)),
                        b=init.const((4 * l,), 0.0)),
            mLSTM=_Node(w=init.glorot((v + e + l + 8 + m, 4 * m)),
                        b=init.const((4 * m,), 0.0)),
            m_lstm_output_projection=_Node(DW=init.xavier_conv(1, m, 1),
                                           biases=init.const((1,), 0.0)))

    def visual(self, images):
        """Backbone, projection, L2 norm: [N, h, w, v_emb]."""
        proj = self.text_sketchyscene.visual_feat_projection
        return ops.l2_normalize(ops.conv2d(self.ResNet(images), proj.DW)
                                + proj.biases)

    def fuse(self, visual, words, seq_len) -> Outputs:
        """``words`` [N, T] end-padded, ``seq_len`` [N]; ``visual`` may
        have batch 1 for N texts against one image."""
        s = self.sizes
        text = self.text_sketchyscene
        n, t_max = words.shape
        if visual.shape[0] != n:
            visual = visual.expand(n, *visual.shape[1:])
        _, h, w, v = visual.shape
        e, l, m = s["w_emb_dim"], s["w_rnn_size"], s["m_rnn_size"]
        valid = torch.arange(t_max, device=words.device)[None] < seq_len[:, None]
        emb = text.embedding[words]
        lang, _ = ops.word_lstm(emb, valid, text.wLSTM.w, text.wLSTM.b, l)
        lang = ops.l2_normalize(lang)
        wm, bm = text.mLSTM.w, text.mLSTM.b
        spatial = torch.from_numpy(ops.spatial_grid(h, w)).to(visual.device)
        pixel_term = (visual.reshape(n, h * w, v) @ wm[:v]
                      + spatial.reshape(1, h * w, 8) @ wm[v + e + l:v + e + l + 8])
        step_term = emb @ wm[v:v + e] + lang @ wm[v + e:v + e + l] + bm
        last_h = ops.pixel_lstm(pixel_term, step_term, wm[v + e + l + 8:],
                                valid)
        y = ops.atanh_transform(last_h.reshape(n, h, w, m))
        proj = text.m_lstm_output_projection
        pred = ops.conv2d(y, proj.DW) + proj.biases
        return Outputs(up=ops.tf1_resize_bilinear(pred, s["H"], s["W"]),
                       pred=pred)

    def forward(self, images, words, seq_len) -> Outputs:
        return self.fuse(self.visual(images), words, seq_len)

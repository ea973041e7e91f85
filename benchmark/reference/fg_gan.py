"""Plain reference of the FG instance generator: the MRU generator of
SketchyGAN with the text-fusion conv-LSTM at its bottleneck, conditional
batch-norm with per-row statistics (as served), one MRU cell per stage.

Widths are those of the paper's FG network (``obj_lib/models_collection.py``,
``obj_lib/mru.py``): base width 64, image 192, noise 256, 25 classes.
Leaf names follow the measured program's state dict.
"""
from __future__ import annotations

import torch
from torch import nn

from . import ops
from .init import Init


class SNConv(nn.Module):
    """SAME conv + bias (+ normalizer) + activation; weights ~ N(0, 0.02)."""

    def __init__(self, init: Init, cin, features, kernel, stride=1,
                 bias=0.0, activation=None):
        super().__init__()
        self.stride, self.activation = stride, activation
        self.weights = init.normal((features, cin, kernel, kernel), 0.02)
        self.biases = init.const((features,), bias)

    def forward(self, x, normalizer=None):
        y = ops.conv2d(x, self.weights, self.stride) + self.biases
        if normalizer is not None:
            y = normalizer(y)
        return activate(y, self.activation)


def activate(x, kind):
    if kind is None:
        return x
    return {"lrelu": ops.lrelu, "miu_relu": ops.miu_relu,
            "tanh": torch.tanh}[kind](x)


class CondBN(nn.Module):
    def __init__(self, init: Init, n_labels, c):
        super().__init__()
        self.offset = init.const((n_labels, c), 0.0)
        self.scale = init.const((n_labels, c), 1.0)

    def forward(self, x, labels):
        return ops.conditional_batch_norm(x, labels, self.offset, self.scale,
                                          per_sample=True)


class NormAct(nn.Module):
    def __init__(self, init, n_labels, c):
        super().__init__()
        self.CondBatchNorm_0 = CondBN(init, n_labels, c)

    def forward(self, x, labels):
        return ops.miu_relu(self.CondBatchNorm_0(x, labels))


class EncoderCell(nn.Module):
    """MRU conv cell without an output gate, mean-pooled by 2."""

    def __init__(self, init, cin, hidden, depth, n_labels):
        super().__init__()
        self.norm_activation_in = NormAct(init, n_labels, hidden)
        self.update_gate = SNConv(init, hidden + cin, hidden, 3, bias=0.5,
                                  activation="lrelu")
        self.image_conv = SNConv(init, cin, hidden, 3)
        self.norm_activation_merge_1 = NormAct(init, n_labels, hidden)
        self.h_conv1_bn = CondBN(init, n_labels, depth)
        self.h_conv1 = SNConv(init, hidden, depth, 3, activation="miu_relu")
        self.h_conv2 = SNConv(init, depth, depth, 3)
        self.ht_proj = SNConv(init, hidden, depth, 1) if hidden != depth \
            else None

    def forward(self, inp, ht, labels):
        rg = ops.minmax_normalize(self.update_gate(torch.cat(
            [self.norm_activation_in(ht, labels), inp], dim=-1)))
        merged = self.norm_activation_merge_1(ht + rg * self.image_conv(inp),
                                              labels)
        h_new = self.h_conv1(merged, lambda y: self.h_conv1_bn(y, labels))
        h_new = self.h_conv2(h_new)
        orig = ht if self.ht_proj is None else self.ht_proj(ht)
        return ops.mean_pool_2x2(orig + h_new)


class DecoderCell(nn.Module):
    """MRU deconv cell with min-max gates; upsamples its state by 2."""

    def __init__(self, init, cin, hidden, depth, n_labels):
        super().__init__()
        full = hidden + cin
        self.update_gate = SNConv(init, full, hidden, 3, activation="lrelu")
        self.output_gate = SNConv(init, full, depth, 3, activation="lrelu")
        self.h_conv1_bn = CondBN(init, n_labels, depth)
        self.h_conv2_bn = CondBN(init, n_labels, depth)
        self.h_conv1 = SNConv(init, full, depth, 3, activation="miu_relu")
        self.h_conv2 = SNConv(init, depth, depth, 3, activation="miu_relu")
        if hidden != depth:
            self.ht_proj_bn = CondBN(init, n_labels, depth)
            self.ht_proj = SNConv(init, hidden, depth, 1,
                                  activation="miu_relu")
        else:
            self.ht_proj = None

    def forward(self, inp, ht, labels):
        ht = ops.nn_upsample_2x(ht)
        full = torch.cat([ht, inp], dim=-1)
        rg = ops.minmax_normalize(self.update_gate(full))
        zg = ops.minmax_normalize(self.output_gate(full))
        h_new = self.h_conv1(torch.cat([rg * ht, inp], dim=-1),
                             lambda y: self.h_conv1_bn(y, labels))
        h_new = self.h_conv2(h_new, lambda y: self.h_conv2_bn(y, labels))
        if self.ht_proj is not None:
            ht = self.ht_proj(ht, lambda y: self.ht_proj_bn(y, labels))
        return ht * (1.0 - zg) + h_new * zg


class Stage(nn.Module):
    def __init__(self, cell, last_norm=None):
        super().__init__()
        self.layer_0 = cell
        self.last_norm = last_norm


class TextFusion(nn.Module):
    """Word LSTM over the front-padded tokens (pads skipped), then the
    masked pixel-LSTM over every bottleneck cell, atanh transform."""

    def __init__(self, init: Init, vocab, c):
        super().__init__()
        self.embedding = init.uniform((vocab, c), 0.08)
        self.wlstm_w = init.glorot((2 * c, 4 * c))
        self.wlstm_b = init.const((4 * c,), 0.0)
        self.alstm_w = init.glorot((4 * c, 4 * c))
        self.alstm_b = init.const((4 * c,), 0.0)

    def forward(self, visual, tokens):
        b, h, w, c = visual.shape
        emb = self.embedding[tokens]
        valid = tokens != 0
        cs = visual.new_zeros((b, c))
        hs = visual.new_zeros((b, c))
        seq = []
        for t in range(tokens.shape[1]):
            nc, nh = ops.lstm_cell(torch.cat([emb[:, t], hs], dim=-1)
                                   @ self.wlstm_w + self.wlstm_b, cs)
            keep = valid[:, t, None]
            cs = torch.where(keep, nc, cs)
            hs = torch.where(keep, nh, hs)
            seq.append(hs)
        lang = ops.l2_normalize(torch.stack(seq, dim=1))
        wa = self.alstm_w
        pixel_term = ops.l2_normalize(visual).reshape(b, h * w, c) @ wa[:c]
        step_term = emb @ wa[c:2 * c] + lang @ wa[2 * c:3 * c] + self.alstm_b
        last = ops.pixel_lstm(pixel_term, step_term, wa[3 * c:], valid)
        return ops.atanh_transform(last.reshape(b, h, w, c))


class MRUGenerator(nn.Module):
    """sketch [B, S, S, 3] in [-1, 1], tokens [B, T], labels [B], noise
    [B, noise_dim] -> [B, S, S, 3] in [-1, 1]."""

    def __init__(self, sizes: dict, init: Init):
        super().__init__()
        if sizes.get("block_type", "MRU") != "MRU" \
                or sizes.get("num_blocks", 1) != 1 \
                or not sizes.get("lstm_hybrid", True):
            raise ValueError("the reference covers the default MRU generator")
        s, nc = sizes["base_channels"], sizes["num_classes"]
        size = sizes["image_size"]
        self.enc_h0 = SNConv(init, 3, 8, 7, stride=2)
        hidden = 8
        for i, feat in enumerate((s, 2 * s, 4 * s, 8 * s)):
            self.add_module(f"enc_stage_{i + 1}", Stage(
                EncoderCell(init, 3, hidden, feat, nc),
                NormAct(init, nc, feat) if i == 3 else None))
            hidden = feat
        self.TextLSTM = TextFusion(init, sizes["vocab_size"], 8 * s)
        hw = 2 * (size // 32)
        self.noise_fc = _Dense(init, sizes["noise_dim"], s * hw * hw)
        dec = ((6 * s, 3 + s), (4 * s, 3 + 2 * s), (2 * s, 3 + s),
               (2 * s, 3 + 8), (s, 3))
        hidden = 8 * s
        for i, (feat, cin) in enumerate(dec):
            self.add_module(f"dec_stage_{i}",
                            Stage(DecoderCell(init, cin, hidden, feat, nc)))
            hidden = feat
        self.out_conv = SNConv(init, s, 3, 7, activation="tanh")

    def forward(self, sketch, tokens, labels, noise_vec):
        b = sketch.shape[0]
        pyramid = [ops.box_downsample(sketch, 2 ** i) for i in range(6)][::-1]
        x_list = [sketch]
        for _ in range(4):
            x_list.append(ops.mean_pool_2x2(x_list[-1]))
        x_list = x_list[::-1]
        ht = self.enc_h0(x_list[-1])
        encoded = [ht]
        for i in range(4):
            stage = getattr(self, f"enc_stage_{i + 1}")
            ht = stage.layer_0(x_list[-2 - i], ht, labels)
            if stage.last_norm is not None:
                ht = stage.last_norm(ht, labels)
            encoded.append(ht)
        feat = self.TextLSTM(encoded[-1], tokens)
        depth = encoded[-1].shape[-1] // 8
        hw = encoded[-1].shape[1] * 2
        noise = self.noise_fc(noise_vec).reshape(b, depth, hw, hw)
        noise = noise.permute(0, 2, 3, 1)
        inputs = [torch.cat([pyramid[1], noise], dim=-1),
                  torch.cat([pyramid[2], encoded[-3]], dim=-1),
                  torch.cat([pyramid[3], encoded[-4]], dim=-1),
                  torch.cat([pyramid[4], encoded[-5]], dim=-1),
                  pyramid[5]]
        ht = feat
        for i, inp in enumerate(inputs):
            ht = getattr(self, f"dec_stage_{i}").layer_0(inp, ht, labels)
        return self.out_conv(ht)


class _Dense(nn.Module):
    """Dense [in, out] + bias, miu-ReLU (the noise projection)."""

    def __init__(self, init: Init, cin, cout):
        super().__init__()
        self.weights = init.glorot((cin, cout))
        self.biases = init.const((cout,), 0.0)

    def forward(self, x):
        return ops.miu_relu(x @ self.weights + self.biases)

"""RMI referring-expression segmentation model
(``sketchyscenecolorization_tpu/models/rmi.py``; reference
``Instance_Matching/RMI_model.py``).

DeepLab-v2 features [N, 96, 96, 2048] -> 1x1 conv to 1000-d + L2 norm; 8-d
spatial coordinates; word embeddings; word LSTM; the multimodal LSTM run
over every feature-map cell; atanh output transform; 1x1 conv to one
channel; TF1 bilinear upsample to 768.

The mLSTM's input projection is factored as in the JAX package
(``rmi.py:150-154``): a pixel term computed once, a step term per word, and
per step only ``h @ W_h``, which ``ops/mlstm.py`` runs (the CUDA kernels on
the card).  All three fusions of the JAX package are here: the default
(``fusion_type='RMI'``), its word-attention variant (``use_attn=True``:
the output is the attention-weighted sum of the per-step h,
``ops/mlstm.attn_weighted_pixel_lstm``) and the recurrent-attention fusion
(``fusion_type='RecurAttn'``, ``ops/recur_attn.py``).  The backbone is
``cfg.backbone``: DeepLab-v2 (``models/deeplab.py``, the default) or
FCN-8s, SegNet or DeepLab-v3+ (``models/backbones.py``), each a submodule
named after its JAX scope (``ResNet``, ``FCN_8s``, ``SegNet``,
``resnet_v1_101``) and each exiting at output stride 8.  With
``compute_dtype='bfloat16'`` the instruction-independent half runs under
the bf16 compute-dtype scope (``ops/conv.py``) and hands f32 features to
the fusion, as JAX ``rmi.py:259-274`` does.  With ``shard_mlstm_pixels``
each fusion's recurrence runs with its pixels sharded over the 'model'
axis of the ambient mesh (``ops/mlstm.py:PixelLSTM``; JAX
``rmi.py:165-196,227-237``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.activations import atanh_transform
from ..ops.conv import compute_dtype_scope, conv2d
from ..ops.image import tf1_resize_bilinear
from ..ops.lstm import masked_lstm_scan
from ..ops.mlstm import attn_weighted_pixel_lstm, masked_pixel_lstm
from ..ops.norm import l2_normalize
from ..ops.recur_attn import recur_attn_pixel_lstm
from ..ops.spatial import generate_spatial_batch
from ..parallel.mesh import current_mesh
from .deeplab import DeepLabV2


def uniform(shape, limit, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def glorot(shape, generator):
    return uniform(shape, (6.0 / (shape[0] + shape[1])) ** 0.5, generator)


def xavier_conv(cout, cin, k, generator):
    limit = (6.0 / (k * k * cin + k * k * cout)) ** 0.5
    return uniform((cout, cin, k, k), limit, generator)


def backbone_spec(cfg):
    """(scope name, module class, feature width) of ``cfg.backbone`` (JAX
    ``rmi.py:48-70``)."""
    if cfg.backbone == "deeplab":
        return "ResNet", DeepLabV2, 2048
    from .backbones import BACKBONES
    if cfg.backbone not in BACKBONES:
        raise ValueError(f"unknown backbone {cfg.backbone!r}")
    cls, dim = BACKBONES[cfg.backbone]
    return cls.SCOPE, cls, dim


class Leaves(nn.Module):
    """A node of a JAX parameter dict: named leaf tensors, no forward."""

    def __init__(self, **leaves: torch.Tensor):
        super().__init__()
        for name, value in leaves.items():
            setattr(self, name, nn.Parameter(value))


class TextParams(nn.Module):
    """The ``text_sketchyscene`` scope (JAX ``rmi.py:84-127``)."""

    def __init__(self, cfg, generator=None, vf_dim: int = 2048):
        super().__init__()
        g = generator
        if cfg.fusion_type == "RecurAttn":
            # the mLSTM consumes the attended sentence vector
            fusion_in = cfg.w_rnn_size
        else:
            fusion_in = cfg.v_emb_dim + cfg.w_emb_dim + cfg.w_rnn_size + 8
        self.visual_feat_projection = Leaves(
            DW=xavier_conv(cfg.v_emb_dim, vf_dim, 1, g),
            biases=torch.zeros(cfg.v_emb_dim))
        self.embedding = nn.Parameter(
            uniform((cfg.vocab_size, cfg.w_emb_dim), 0.08, g))
        self.wLSTM = Leaves(
            w=glorot((cfg.w_emb_dim + cfg.w_rnn_size, 4 * cfg.w_rnn_size), g),
            b=torch.zeros(4 * cfg.w_rnn_size))
        self.mLSTM = Leaves(
            w=glorot((fusion_in + cfg.m_rnn_size, 4 * cfg.m_rnn_size), g),
            b=torch.zeros(4 * cfg.m_rnn_size))
        self.m_lstm_output_projection = Leaves(
            DW=xavier_conv(1, cfg.m_rnn_size, 1, g), biases=torch.zeros(1))
        if cfg.use_attn:
            self.attn_fc = Leaves(DW=glorot((cfg.w_rnn_size, 1), g),
                                  biases=torch.zeros(1))
        if cfg.fusion_type == "RecurAttn":
            self.h_proj = Leaves(
                DW=glorot((cfg.m_rnn_size, cfg.w_rnn_size), g),
                biases=torch.zeros(cfg.w_rnn_size))


class RMIOutputs(NamedTuple):
    up: torch.Tensor      # [N, H, W, 1] logits at full resolution
    sigm: torch.Tensor    # sigmoid(up)
    pred: torch.Tensor    # [N, h, w, 1] logits at feature resolution


class RMI(nn.Module):
    def __init__(self, cfg, generator=None):
        super().__init__()
        if cfg.fusion_type not in ("RMI", "RecurAttn"):
            raise ValueError(f"unknown fusion_type {cfg.fusion_type!r}")
        self.cfg = cfg
        self.scope, cls, dim = backbone_spec(cfg)
        self.add_module(self.scope, cls(generator=generator))
        self.text_sketchyscene = TextParams(cfg, generator, dim)

    @property
    def backbone(self) -> nn.Module:
        return getattr(self, self.scope)

    def forward(self, images: torch.Tensor, words: torch.Tensor,
                seq_len: torch.Tensor) -> RMIOutputs:
        """The whole model (JAX ``rmi.apply``)."""
        return self.apply_fused(self.extract_visual(images), words, seq_len)

    def extract_visual(self, images: torch.Tensor) -> torch.Tensor:
        """Backbone + 1x1 projection + L2 norm -> [N, h, w, v_emb] f32,
        under the compute-dtype scope of ``cfg.compute_dtype``.  A frozen
        backbone (no parameter requires grad, as in fusion-only training)
        runs without autograd, so none of its activations are kept."""
        proj = self.text_sketchyscene.visual_feat_projection
        frozen = not any(p.requires_grad for p in self.backbone.parameters())
        with compute_dtype_scope(self.cfg.compute_dtype):
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not frozen):
                feat = self.backbone(images)
            visual = conv2d(feat, proj.DW) + proj.biases
        return l2_normalize(visual.float(), dim=-1)

    def _rmi_fusion(self, visual_norm, spatial, emb, lang, seq_len):
        """Factored mLSTM over all pixels -> m_last_h [N, h, w, m]."""
        cfg = self.cfg
        n, h, w, _ = visual_norm.shape
        t_max = emb.shape[1]
        wm = self.text_sketchyscene.mLSTM.w
        bm = self.text_sketchyscene.mLSTM.b
        v, e, l = cfg.v_emb_dim, cfg.w_emb_dim, cfg.w_rnn_size
        w_v = wm[:v]
        w_w = wm[v:v + e]
        w_l = wm[v + e:v + e + l]
        w_s = wm[v + e + l:v + e + l + 8]
        w_h = wm[v + e + l + 8:]
        pixel_term = (visual_norm.reshape(n, h * w, v) @ w_v
                      + spatial.reshape(n, h * w, 8) @ w_s)      # [N, P, 4m]
        step_term = emb @ w_w + lang @ w_l + bm                  # [N, T, 4m]
        steps = torch.arange(t_max, device=seq_len.device)
        valid = steps[None, :] < seq_len[:, None]                # [N, T]
        if cfg.use_attn:
            # word attention (JAX ``rmi.py:156-176``): softmax over ALL T
            # of fc(lang); the pad rows of lang are l2_normalize(0) = 0, so
            # their logit is the bias and they take weight
            fc = self.text_sketchyscene.attn_fc
            attn = torch.softmax((lang @ fc.DW)[..., 0] + fc.biases, dim=-1)
            m_last = attn_weighted_pixel_lstm(pixel_term, step_term, w_h,
                                              valid, attn, self._mesh())
        else:
            m_last = masked_pixel_lstm(pixel_term, step_term, w_h, valid,
                                       self._mesh())
        return m_last.reshape(n, h, w, cfg.m_rnn_size)

    def _mesh(self):
        """With ``shard_mlstm_pixels``, the ambient mesh whose 'model' axis
        shards the recurrence's pixels (JAX's ``shard_map`` needs
        ``jax.set_mesh``); else None."""
        if not self.cfg.shard_mlstm_pixels:
            return None
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("shard_mlstm_pixels needs a mesh: run the model "
                             "under parallel.set_mesh(mesh)")
        return mesh

    def _recur_attn_fusion(self, visual_norm, lang_out, words):
        """Recurrent-attention fusion (JAX ``rmi.py:205-240``): h starts at
        the visual features, attends over the RAW word-LSTM outputs each
        step, and skips every step whose token is <pad> (``words != 0``)."""
        n, h, w, v = visual_norm.shape
        text = self.text_sketchyscene
        args = (visual_norm.reshape(n, h * w, v), lang_out, text.h_proj.DW,
                text.h_proj.biases, text.mLSTM.w, text.mLSTM.b, words != 0)
        m_last = recur_attn_pixel_lstm(*args, self._mesh())
        return m_last.reshape(n, h, w, self.cfg.m_rnn_size)

    def apply_fused(self, visual_norm: torch.Tensor, words: torch.Tensor,
                    seq_len: torch.Tensor) -> RMIOutputs:
        """Instruction-dependent half; ``visual_norm`` may have batch 1 for
        N instructions against one sketch."""
        cfg = self.cfg
        text = self.text_sketchyscene
        n = words.shape[0]
        if visual_norm.shape[0] != n:
            visual_norm = visual_norm.expand(n, *visual_norm.shape[1:])
        spatial = generate_spatial_batch(n, cfg.vf_h, cfg.vf_w,
                                         device=visual_norm.device)
        emb = text.embedding[words]                              # [N, T, e]
        w_out, _ = masked_lstm_scan(emb, seq_len, text.wLSTM.w,
                                    text.wLSTM.b, cfg.w_rnn_size)
        if cfg.fusion_type == "RMI":
            lang = l2_normalize(w_out, dim=-1)
            m_last = self._rmi_fusion(visual_norm, spatial, emb, lang,
                                      seq_len)
        else:
            m_last = self._recur_attn_fusion(visual_norm, w_out, words)
        y = atanh_transform(m_last)
        proj = text.m_lstm_output_projection
        pred = conv2d(y, proj.DW) + proj.biases                  # [N, h, w, 1]
        up = tf1_resize_bilinear(pred, cfg.H, cfg.W)
        return RMIOutputs(up=up, sigm=torch.sigmoid(up), pred=pred)

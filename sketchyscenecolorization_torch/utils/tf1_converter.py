"""TF1-checkpoint -> parameter-tree converter (name mapping + layout
fixes).  Copy of ``sketchyscenecolorization_tpu/utils/tf1_converter.py``
(the port imports nothing of the JAX package); NumPy only.

TensorFlow is not needed: the converter consumes a flat
``{tf_variable_name: np.ndarray}`` dict -- produced by
``tf.train.load_checkpoint`` elsewhere and saved with ``np.savez``
(``scripts/export_tf1_checkpoint.py``) -- and emits trees in the JAX
package's layout (HWIO kernels, the flax names).  They reach the port's
modules through the weight bridge:
``load_jax_tree(module, merge_converted(export_jax_tree(module), tree))``
(``utils/bridge.py``), whose owners' ``FROM_HWIO`` take the transposed and
depthwise kernels to torch's layouts.

Name sources (reference):
- backbone: ``ResNet/group_{g}_{u}/block_{b}/{conv,bn}/...``
  (``Instance_Matching/deeplab_model.py:51-107,176-260``), conv weight 'DW',
  BN {beta, gamma, mean, variance, factor};
- text head: ``text_sketchyscene/{visual_feat_projection,
  m_lstm_output_projection}/{DW,biases}``, ``text_sketchyscene/embedding``,
  LSTMs ``text_sketchyscene/{wLSTM,mLSTM}/lstm_cell/{kernel,bias}``
  (``RMI_model.py:113-200``).  TF's LSTMCell kernel is [(in + h), 4h] with
  gate order (i, j, f, o) -- identical to the trees' layout, so kernels
  copy verbatim;
- transposed-conv filters are [kh, kw, out, in] in TF and HWIO in the
  trees, so they swap their last two axes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..config import MatchingConfig

Params = Dict[str, Any]
TFVars = Dict[str, np.ndarray]


def load_tf_vars_npz(path: str) -> TFVars:
    """Flat TF-name -> array dict from an npz export."""
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files}


def swap_deconv_filter(w: np.ndarray) -> np.ndarray:
    """[kh, kw, out, in] (TF transposed conv) -> [kh, kw, in, out] (HWIO)."""
    return np.swapaxes(w, 2, 3)


# ------------------------------------------------------------------ matching

BN_LEAVES = ("beta", "gamma", "mean", "variance", "factor")
DEEPLAB_NUM_UNITS = (3, 4, 23, 3)


def matching_name_map(cfg: Optional[MatchingConfig] = None
                      ) -> Dict[str, Tuple[str, ...]]:
    """{tf_name: our-tree path} for the RMI model with the DeepLab-v2
    backbone.  Paths are tuples into the tree that
    ``export_jax_tree(RMI(cfg))`` gives."""
    cfg = cfg or MatchingConfig()
    m: Dict[str, Tuple[str, ...]] = {}

    # --- backbone stem
    m["ResNet/group_1/conv1/DW"] = ("ResNet", "group_1", "conv1", "DW")
    for leaf in BN_LEAVES:
        m[f"ResNet/group_1/bn_conv1/{leaf}"] = \
            ("ResNet", "group_1", "bn_conv1", leaf)

    # --- bottleneck groups
    for g, units in enumerate(DEEPLAB_NUM_UNITS, start=2):
        for u in range(units):
            scope = f"group_{g}_{u}"
            blocks = ["block_1", "block_2", "block_3"]
            if u == 0:
                blocks.append("block_add")
            for b in blocks:
                m[f"ResNet/{scope}/{b}/conv/DW"] = \
                    ("ResNet", scope, b, "conv", "DW")
                for leaf in BN_LEAVES:
                    m[f"ResNet/{scope}/{b}/bn/{leaf}"] = \
                        ("ResNet", scope, b, "bn", leaf)

    # --- text head
    t = "text_sketchyscene"
    m[f"{t}/visual_feat_projection/DW"] = (t, "visual_feat_projection", "DW")
    m[f"{t}/visual_feat_projection/biases"] = \
        (t, "visual_feat_projection", "biases")
    m[f"{t}/embedding"] = (t, "embedding")
    m[f"{t}/wLSTM/lstm_cell/kernel"] = (t, "wLSTM", "w")
    m[f"{t}/wLSTM/lstm_cell/bias"] = (t, "wLSTM", "b")
    if cfg.fusion_type == "RecurAttn":
        # ``Recurrent_Attn`` scope (RMI_model.py:224-273): MultiRNNCell mLSTM
        # plus the h->word projection
        ra = f"{t}/Recurrent_Attn"
        cell = "multi_rnn_cell/cell_0/lstm_cell"
        m[f"{ra}/mLSTM/{cell}/kernel"] = (t, "mLSTM", "w")
        m[f"{ra}/mLSTM/{cell}/bias"] = (t, "mLSTM", "b")
        m[f"{ra}/h_proj/DW"] = (t, "h_proj", "DW")
        m[f"{ra}/h_proj/biases"] = (t, "h_proj", "biases")
    else:
        m[f"{t}/mLSTM/lstm_cell/kernel"] = (t, "mLSTM", "w")
        m[f"{t}/mLSTM/lstm_cell/bias"] = (t, "mLSTM", "b")
    if cfg.use_attn:
        m[f"{t}/attn_fc/DW"] = (t, "attn_fc", "DW")
        m[f"{t}/attn_fc/biases"] = (t, "attn_fc", "biases")
    m[f"{t}/m_lstm_output_projection/DW"] = \
        (t, "m_lstm_output_projection", "DW")
    m[f"{t}/m_lstm_output_projection/biases"] = \
        (t, "m_lstm_output_projection", "biases")
    return m


def _set_path(tree: Params, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _convert(name_map: Dict[str, Tuple[str, ...]], tf_vars: TFVars,
             strict: bool, swap=lambda tf_name, path: False) -> Params:
    """Place every mapped variable of ``tf_vars`` at its tree path, its
    filter axis-swapped where ``swap(tf_name, path)``; ``strict`` raises
    when a mapped variable is missing, otherwise it is skipped."""
    tree: Params = {}
    missing: List[str] = []
    for tf_name, path in name_map.items():
        if tf_name not in tf_vars:
            missing.append(tf_name)
            continue
        value = np.asarray(tf_vars[tf_name])
        if swap(tf_name, path):
            value = swap_deconv_filter(value)
        _set_path(tree, path, value)
    if strict and missing:
        raise KeyError(f"{len(missing)} variables missing from the TF "
                       f"checkpoint, first few: {missing[:5]}")
    return tree


def convert_matching(tf_vars: TFVars, cfg: Optional[MatchingConfig] = None,
                     strict: bool = False) -> Params:
    """Flat TF vars -> the ``models/rmi.RMI`` parameter tree.

    ``strict=True`` raises when a mapped variable is missing; otherwise it is
    skipped (partial restores: e.g. a backbone-only pretrained checkpoint,
    matching the reference's scope-filtered first-run restore,
    ``matching_main.py:123-142``)."""
    return _convert(matching_name_map(cfg), tf_vars, strict)


def merge_converted(params: Params, converted: Params) -> Params:
    """Overlay a (possibly partial) converted tree onto freshly-initialized
    parameters, shape-checking every leaf."""
    def merge(dst, src, prefix=""):
        out = dict(dst)
        for k, v in src.items():
            if isinstance(v, dict):
                out[k] = merge(dst.get(k, {}), v, f"{prefix}{k}/")
            else:
                if k in dst and np.shape(dst[k]) != np.shape(v):
                    raise ValueError(
                        f"shape mismatch at {prefix}{k}: "
                        f"{np.shape(dst[k])} vs checkpoint {np.shape(v)}")
                out[k] = v
        return out
    return merge(params, converted)


# ------------------------------------------------- alternate RMI backbones

def fcn8s_name_map() -> Dict[str, Tuple[str, ...]]:
    """{tf_name: our-tree path} for the FCN-8s backbone
    (``fcn8s_model.py:8-53`` VGG stack under scope FCN_8s, fc6/7/8
    :118-133, deconv1-3 :134-156; leaves DW/bias).  Deconv filters are
    [kh, kw, out, in] in TF -- pass through ``swap_deconv_filter``."""
    from ..models.backbones import VGG_LAYERS
    s = "FCN_8s"
    m: Dict[str, Tuple[str, ...]] = {}
    names = [spec[0] for spec in VGG_LAYERS if spec[0].startswith("conv")]
    names += ["fc6", "fc7", "fc8", "deconv1", "deconv2", "deconv3"]
    for name in names:
        m[f"{s}/{name}/DW"] = (s, name, "DW")
        m[f"{s}/{name}/bias"] = (s, name, "bias")
    return m


def convert_fcn8s(tf_vars: TFVars, strict: bool = False) -> Params:
    return _convert(fcn8s_name_map(), tf_vars, strict,
                    lambda tf_name, path: ("/deconv" in tf_name
                                           and path[-1] == "DW"))


def load_vgg19_mat(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """imagenet-vgg-verydeep-19.mat -> {conv name: (kernel HWIO, bias [C])}.

    Reproduces the reference loader exactly (``fcn8s_model.py:8-44``,
    ``utils/tensorflow_util.py:47-51``): layer i of the squeezed matconvnet
    'layers' cell array holds (kernels, bias) at [i][0][0][0][0]; matconvnet
    kernels are [width, height, in, out] and transpose to TF's
    [height, width, in, out]."""
    import scipy.io
    data = scipy.io.loadmat(path)
    layers = np.squeeze(data["layers"])
    layer_names = (
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1",
        "conv2_1", "relu2_1", "conv2_2", "relu2_2", "pool2",
        "conv3_1", "relu3_1", "conv3_2", "relu3_2", "conv3_3",
        "relu3_3", "conv3_4", "relu3_4", "pool3",
        "conv4_1", "relu4_1", "conv4_2", "relu4_2", "conv4_3",
        "relu4_3", "conv4_4", "relu4_4", "pool4",
        "conv5_1", "relu5_1", "conv5_2", "relu5_2", "conv5_3",
        "relu5_3", "conv5_4", "relu5_4",
    )
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for i, name in enumerate(layer_names):
        if not name.startswith("conv"):
            continue
        kernels, bias = layers[i][0][0][0][0]
        out[name] = (np.transpose(kernels, (1, 0, 2, 3)).astype(np.float32),
                     np.asarray(bias).reshape(-1).astype(np.float32))
    return out


def vgg19_to_fcn8s(vgg: Dict[str, Tuple[np.ndarray, np.ndarray]]) -> Params:
    """VGG-19 conv weights -> a partial FCN_8s tree (the reference's
    ``use_vgg_weight=True`` initialization covers the conv stack only);
    overlay with ``merge_converted``."""
    tree: Params = {"FCN_8s": {}}
    for name, (dw, bias) in vgg.items():
        tree["FCN_8s"][name] = {"DW": dw, "bias": bias}
    return tree


SEGNET_REF_LAYERS = [
    ("enc_1", 2), ("enc_2", 2), ("enc_3", 3), ("enc_4", 3), ("enc_5", 3),
    ("dec_5", 3), ("dec_4", 2),      # dec_4/conv3 is commented out upstream
    ("dec_3", 3), ("dec_2", 2), ("dec_1", 2),
]


def segnet_name_map(through_intermediate_only: bool = True
                    ) -> Dict[str, Tuple[str, ...]]:
    """{tf_name: our-tree path} for SegNet (``segnet_model.py:55-148``):
    conv leaves DW/biases; the contrib ``batch_norm`` beta uniquifies as
    BatchNorm, BatchNorm_1, ... per enclosing enc/dec scope (creation
    order = conv order).  Default maps only the layers the RMI intermediate
    exit consumes (through dec_4/conv2): the reference's deeper decoder is
    channel-inconsistent (its dec_4 256-reduction is commented out), so its
    dec_3+ variables have shapes our repaired decoder deliberately does not
    reproduce -- see PARITY.md 'Known deltas'."""
    s = "SegNet"
    m: Dict[str, Tuple[str, ...]] = {}
    layers = SEGNET_REF_LAYERS
    if through_intermediate_only:
        layers = [(n, k) for n, k in layers
                  if n.startswith("enc") or n in ("dec_5", "dec_4")]
    for scope, n_convs in layers:
        for i in range(n_convs):
            conv = f"conv{i + 1}"
            m[f"{s}/{scope}/{conv}/DW"] = (s, scope, conv, "DW")
            m[f"{s}/{scope}/{conv}/biases"] = (s, scope, conv, "biases")
            bn = "BatchNorm" if i == 0 else f"BatchNorm_{i}"
            m[f"{s}/{scope}/{bn}/beta"] = (s, scope, conv, "bn_beta")
    return m


def convert_segnet(tf_vars: TFVars, strict: bool = False,
                   through_intermediate_only: bool = True) -> Params:
    return _convert(segnet_name_map(through_intermediate_only), tf_vars,
                    strict)


V3P_BN_LEAVES = (("beta", "beta"), ("gamma", "gamma"),
                 ("moving_mean", "mean"), ("moving_variance", "variance"))
V3P_NUM_UNITS = (3, 4, 23, 3)


def deeplab_v3plus_name_map() -> Dict[str, Tuple[str, ...]]:
    """{tf_name: our-tree path} for DeepLab-v3+ (slim scopes:
    root ``resnet_v1_101/conv1_{1,2,3}`` from the beta root block
    (``deeplab_v3plus_model.py:68-84``), bottleneck units
    ``resnet_v1_101/block{b}/unit_{u}/bottleneck_v1/*`` (:11-61), ASPP
    ``image_pooling/aspp0/aspp{1,2,3}_{depthwise,pointwise}/concat_projection``
    (:605-651), decoder ``decoder/feature_projection0``/``decoder_conv{0,1}``
    (:756-848), and ``logits/logits`` (:891-911)).  slim conv weights are
    'weights' (HWIO, bias-free under BN); depthwise kernels are
    'depthwise_weights' [kh, kw, in, 1] -- both copy verbatim."""
    r = "resnet_v1_101"
    m: Dict[str, Tuple[str, ...]] = {}

    def conv_bn(tf_scope: str, path: Tuple[str, ...]) -> None:
        m[f"{tf_scope}/weights"] = path + ("DW",)
        for tf_leaf, ours in V3P_BN_LEAVES:
            m[f"{tf_scope}/BatchNorm/{tf_leaf}"] = path + ("bn", ours)

    def sep_conv(tf_scope: str, path: Tuple[str, ...]) -> None:
        m[f"{tf_scope}_depthwise/depthwise_weights"] = \
            path + ("depthwise", "DW")
        for tf_leaf, ours in V3P_BN_LEAVES:
            m[f"{tf_scope}_depthwise/BatchNorm/{tf_leaf}"] = \
                path + ("depthwise", "bn", ours)
        m[f"{tf_scope}_pointwise/weights"] = path + ("pointwise", "DW")
        for tf_leaf, ours in V3P_BN_LEAVES:
            m[f"{tf_scope}_pointwise/BatchNorm/{tf_leaf}"] = \
                path + ("pointwise", "bn", ours)

    for i in (1, 2, 3):
        conv_bn(f"{r}/conv1_{i}", (r, "root", f"conv1_{i}"))
    for b, units in enumerate(V3P_NUM_UNITS, 1):
        for u in range(1, units + 1):
            base = f"{r}/block{b}/unit_{u}/bottleneck_v1"
            path = (r, f"block{b}", f"unit_{u}")
            for conv in ("conv1", "conv2", "conv3"):
                conv_bn(f"{base}/{conv}", path + (conv,))
            if u == 1:
                conv_bn(f"{base}/shortcut", path + ("shortcut",))
    conv_bn("image_pooling", (r, "aspp", "image_pooling"))
    conv_bn("aspp0", (r, "aspp", "aspp0"))
    for i in (1, 2, 3):
        sep_conv(f"aspp{i}", (r, "aspp", f"aspp{i}"))
    conv_bn("concat_projection", (r, "aspp", "concat_projection"))
    conv_bn("decoder/feature_projection0", (r, "decoder", "feature_projection"))
    sep_conv("decoder/decoder_conv0", (r, "decoder", "decoder_conv0"))
    sep_conv("decoder/decoder_conv1", (r, "decoder", "decoder_conv1"))
    m["logits/logits/weights"] = (r, "logits", "DW")
    m["logits/logits/biases"] = (r, "logits", "biases")
    return m


def convert_deeplab_v3plus(tf_vars: TFVars, strict: bool = False) -> Params:
    return _convert(deeplab_v3plus_name_map(), tf_vars, strict)


# ---------------------------------------------------------------- BG GAN

BG_NUM_RESIDUAL_UNITS = (3, 4, 6, 3)


def _bg_block_entries(m, tf_scope: str, our_scope: str, kind: str) -> None:
    """One bottleneck block's conv+bn leaves.

    kind: 'en' (block_1/add = pad-1 conv), 'de' (block_1/add = deconv,
    filters transposed), 'pu' (all conv_ex, no block_add).
    Helper scopes (``bg_colorization_main.py:41-98``): conv->'conv',
    conv_ex->'conv_ex', deconv->'deconv', batchnorm->'batchnorm'.
    """
    specs = {
        "en": [("block_1", "conv", "block_1_conv"),
               ("block_2", "conv_ex", "block_2_conv"),
               ("block_3", "conv_ex", "block_3_conv"),
               ("block_add", "conv", "block_add_conv")],
        "de": [("block_1", "deconv", "block_1_deconv"),
               ("block_2", "conv_ex", "block_2_conv"),
               ("block_3", "conv_ex", "block_3_conv"),
               ("block_add", "deconv", "block_add_deconv")],
        "pu": [("block_1", "conv_ex", "block_1_conv"),
               ("block_2", "conv_ex", "block_2_conv"),
               ("block_3", "conv_ex", "block_3_conv")],
    }[kind]
    for tf_block, conv_scope, our_conv in specs:
        m[f"{tf_scope}/{tf_block}/{conv_scope}/filter"] = \
            (our_scope, our_conv, "filter")
        bn_key = our_conv.rsplit("_", 1)[0] + "_bn"
        for leaf in ("offset", "scale"):
            m[f"{tf_scope}/{tf_block}/batchnorm/{leaf}"] = \
                (our_scope, bn_key, leaf)


def bg_generator_name_map(multi_residual: bool = True
                          ) -> Dict[str, Tuple[str, ...]]:
    """{tf_name: our-tree path} for the BG residual generator
    (``bg_colorization_main.py:302-420``; LSTM var names from the
    MultiRNNCell([BasicLSTMCell]) calls inside scopes RNN/WLSTM and
    RNN/ALSTM, :178-199).  Deconv filters are [kh,kw,out,in] in TF --
    pass them through ``swap_deconv_filter``."""
    g = "generator"
    m: Dict[str, Tuple[str, ...]] = {}

    m[f"{g}/encoder_1/conv_ex/filter"] = ("encoder_1_conv", "filter")
    for leaf in ("offset", "scale"):
        m[f"{g}/encoder_1/batchnorm/{leaf}"] = ("encoder_1_bn", leaf)

    for e in range(4):
        scope = f"encoder_{e + 2}_0"
        _bg_block_entries(m, f"{g}/{scope}", scope, "en")
        if multi_residual:
            for u in range(1, BG_NUM_RESIDUAL_UNITS[e]):
                scope_u = f"encoder_{e + 2}_{u}"
                _bg_block_entries(m, f"{g}/{scope_u}", scope_u, "pu")

    t = f"{g}/mLSTM_G"
    m[f"{t}/embedding"] = ("mLSTM_G", "embedding")
    m[f"{t}/RNN/WLSTM/multi_rnn_cell/cell_0/basic_lstm_cell/kernel"] = \
        ("mLSTM_G", "wlstm_w")
    m[f"{t}/RNN/WLSTM/multi_rnn_cell/cell_0/basic_lstm_cell/bias"] = \
        ("mLSTM_G", "wlstm_b")
    m[f"{t}/RNN/ALSTM/multi_rnn_cell/cell_0/basic_lstm_cell/kernel"] = \
        ("mLSTM_G", "alstm_w")
    m[f"{t}/RNN/ALSTM/multi_rnn_cell/cell_0/basic_lstm_cell/bias"] = \
        ("mLSTM_G", "alstm_b")

    m[f"{g}/region_br_projection/conv_ex/filter"] = \
        ("region_br_projection_conv", "filter")
    for leaf in ("offset", "scale"):
        m[f"{g}/region_br_projection/batchnorm/{leaf}"] = \
            ("region_br_projection_bn", leaf)

    for d, skip in enumerate((5, 4, 3, 2)):
        scope = f"decoder_{skip}_0"
        _bg_block_entries(m, f"{g}/{scope}", scope, "de")
        if multi_residual:
            for u in range(1, BG_NUM_RESIDUAL_UNITS[skip - 2]):
                scope_u = f"decoder_{skip}_{u}"
                _bg_block_entries(m, f"{g}/{scope_u}", scope_u, "pu")
        m[f"{g}/region_br_{skip}/deconv/filter"] = \
            (f"region_br_{skip}_deconv", "filter")
        for leaf in ("offset", "scale"):
            m[f"{g}/region_br_{skip}/batchnorm/{leaf}"] = \
                (f"region_br_{skip}_bn", leaf)

    m[f"{g}/decoder_1/deconv/filter"] = ("decoder_1_deconv", "filter")
    m[f"{g}/region_br_1/deconv/filter"] = ("region_br_1_deconv", "filter")
    for leaf in ("offset", "scale"):
        m[f"{g}/decoder_1/batchnorm/{leaf}"] = ("decoder_1_bn", leaf)
        m[f"{g}/region_br_1/batchnorm/{leaf}"] = ("region_br_1_bn", leaf)
    return m


def convert_bg_generator(tf_vars: TFVars, multi_residual: bool = True,
                         strict: bool = False) -> Params:
    """Flat TF vars -> the ``models/bg_gan.ResidualGenerator`` param tree
    (deconv filters axis-swapped to HWIO)."""
    return _convert(bg_generator_name_map(multi_residual), tf_vars, strict,
                    lambda tf_name, path: "/deconv/filter" in tf_name)


# ---------------------------------------------------------------- FG GAN

def _fg_conv_block_entries(m, tf_scope: str, path_prefix: Tuple[str, ...],
                           block_params: Params) -> None:
    """MRU conv cell v3 (``mru.py:353-461``).  Unnamed convs uniquify as
    Conv, Conv_1, ... in creation order: image conv, h conv1 (its conditional
    BN builds inside the same scope), h conv2, then the optional ht
    projection."""
    def bn(tf_sub, our_sub):
        for leaf in ("offset", "scale"):
            m[f"{tf_scope}/{tf_sub}/{leaf}"] = path_prefix + our_sub + (leaf,)

    bn("norm_activation_in", ("norm_activation_in", "CondBatchNorm_0"))
    for leaf in ("weights", "biases"):
        m[f"{tf_scope}/update_gate/{leaf}"] = \
            path_prefix + ("update_gate", leaf)
        m[f"{tf_scope}/Conv/{leaf}"] = path_prefix + ("image_conv", leaf)
        m[f"{tf_scope}/Conv_1/{leaf}"] = path_prefix + ("h_conv1", leaf)
        m[f"{tf_scope}/Conv_2/{leaf}"] = path_prefix + ("h_conv2", leaf)
    bn("norm_activation_merge_1", ("norm_activation_merge_1", "CondBatchNorm_0"))
    bn("Conv_1", ("h_conv1_bn",))
    if "ht_proj" in block_params:
        for leaf in ("weights", "biases"):
            m[f"{tf_scope}/Conv_3/{leaf}"] = path_prefix + ("ht_proj", leaf)


def _fg_deconv_block_entries(m, tf_scope: str, path_prefix: Tuple[str, ...],
                             block_params: Params) -> None:
    """MRU deconv cell v2 (``mru.py:527-591``).  ALL convs are unnamed:
    Conv=update gate, Conv_1=output gate, Conv_2/Conv_3=h convs (conditional
    BN inside each scope), Conv_4=optional ht projection (with BN)."""
    pairs = [("Conv", ("update_gate",), None),
             ("Conv_1", ("output_gate",), None),
             ("Conv_2", ("h_conv1",), ("h_conv1_bn",)),
             ("Conv_3", ("h_conv2",), ("h_conv2_bn",))]
    if "ht_proj" in block_params:
        pairs.append(("Conv_4", ("ht_proj",), ("ht_proj_bn",)))
    for tf_sub, our_conv, our_bn in pairs:
        for leaf in ("weights", "biases"):
            m[f"{tf_scope}/{tf_sub}/{leaf}"] = path_prefix + our_conv + (leaf,)
        if our_bn is not None:
            for leaf in ("offset", "scale"):
                m[f"{tf_scope}/{tf_sub}/{leaf}"] = \
                    path_prefix + our_bn + (leaf,)


def fg_generator_name_map(g_params: Params) -> Dict[str, Tuple[str, ...]]:
    """{tf_name: our-tree path} for the FG MRU generator
    (``models_collection.py:251-377``, scopes derived from the unnamed-conv
    creation order in ``mru.py``; num_blocks=1).  Takes the generator's
    tree (``export_jax_tree(generator)``) so optional projection convs
    match the real topology."""
    g = "generator"
    m: Dict[str, Tuple[str, ...]] = {}

    # root-scope unnamed convs, creation order: encoder h0, final out conv
    for leaf in ("weights", "biases"):
        m[f"{g}/Conv/{leaf}"] = ("enc_h0", leaf)
        m[f"{g}/Conv_1/{leaf}"] = ("out_conv", leaf)

    for u in range(1, 5):                           # encoder unit_num 1..4
        _fg_conv_block_entries(
            m, f"{g}/mru_conv_unit_t_{u}_layer_0",
            (f"enc_stage_{u}", "layer_0"),
            g_params[f"enc_stage_{u}"]["layer_0"])
    for leaf in ("offset", "scale"):
        m[f"{g}/mru_conv_unit_last_norm/{leaf}"] = \
            ("enc_stage_4", "last_norm", "CondBatchNorm_0", leaf)

    t = f"{g}/TextLSTM"
    cell = "multi_rnn_cell/cell_0/basic_lstm_cell"
    m[f"{t}/embedding"] = ("TextLSTM", "embedding")
    m[f"{t}/RNN/WLSTM/{cell}/kernel"] = ("TextLSTM", "wlstm_w")
    m[f"{t}/RNN/WLSTM/{cell}/bias"] = ("TextLSTM", "wlstm_b")
    m[f"{t}/RNN/ALSTM/{cell}/kernel"] = ("TextLSTM", "alstm_w")
    m[f"{t}/RNN/ALSTM/{cell}/bias"] = ("TextLSTM", "alstm_b")

    for leaf in ("weights", "biases"):
        m[f"{g}/fully_connected/{leaf}"] = ("noise_fc", leaf)

    for i, u in enumerate((0, 2, 4, 6, 8)):         # decoder unit numbering
        _fg_deconv_block_entries(
            m, f"{g}/mru_deconv_unit_t_{u}_layer_0",
            (f"dec_stage_{i}", "layer_0"),
            g_params[f"dec_stage_{i}"]["layer_0"])
    return m


def convert_fg_generator(tf_vars: TFVars, g_params_template: Params,
                         strict: bool = False) -> Params:
    """Flat TF vars -> the ``models/fg_gan.MRUGenerator`` param tree."""
    return _convert(fg_generator_name_map(g_params_template), tf_vars, strict)


def _fg_disc_block_entries(m, tf_scope: str, prefix: Tuple[str, ...],
                           block_params: Params) -> None:
    """Discriminator MRU cell v3: normalizer None, PReLU activations (their
    scalar lives under '<scope>/prelu/param'), spectral-norm 'u' under each
    conv scope."""
    m[f"{tf_scope}/norm_activation_in/prelu/param"] = \
        ("params",) + prefix + ("norm_activation_in", "prelu_param")
    m[f"{tf_scope}/norm_activation_merge_1/prelu/param"] = \
        ("params",) + prefix + ("norm_activation_merge_1", "prelu_param")
    convs = [("update_gate", ("update_gate",)), ("Conv", ("image_conv",)),
             ("Conv_1", ("h_conv1",)), ("Conv_2", ("h_conv2",))]
    if "ht_proj" in block_params:
        convs.append(("Conv_3", ("ht_proj",)))
    for tf_sub, ours in convs:
        for leaf in ("weights", "biases"):
            m[f"{tf_scope}/{tf_sub}/{leaf}"] = ("params",) + prefix + ours + (leaf,)
        m[f"{tf_scope}/{tf_sub}/u"] = ("sn",) + prefix + ours + ("u",)
    m[f"{tf_scope}/Conv_1/prelu/param"] = \
        ("params",) + prefix + ("h_conv1", "prelu_param")


def fg_discriminator_name_map(d_params: Params) -> Dict[str, Tuple[str, ...]]:
    """{tf_name: ('params'|'sn', *path)} for the FG MRU discriminator
    (``models_collection.py:676-786``; ACGAN head, proj_d=False)."""
    d = "discriminator"
    m: Dict[str, Tuple[str, ...]] = {}
    for leaf in ("weights", "biases"):
        m[f"{d}/Conv/{leaf}"] = ("params", "h0", leaf)
        m[f"{d}/Conv_1/{leaf}"] = ("params", "disc_out", leaf)
        m[f"{d}/fully_connected/{leaf}"] = ("params", "ac_logits", leaf)
    m[f"{d}/Conv/prelu/param"] = ("params", "h0", "prelu_param")
    m[f"{d}/Conv/u"] = ("sn", "h0", "u")
    m[f"{d}/Conv_1/u"] = ("sn", "disc_out", "u")
    m[f"{d}/fully_connected/u"] = ("sn", "ac_logits", "u")
    for u in range(1, 5):
        _fg_disc_block_entries(m, f"{d}/mru_conv_unit_t_{u}_layer_0",
                               (f"stage_{u}", "layer_0"),
                               d_params[f"stage_{u}"]["layer_0"])
    m[f"{d}/mru_conv_unit_last_norm/prelu/param"] = \
        ("params", "stage_4", "last_norm", "prelu_param")
    return m


def convert_fg_discriminator(tf_vars: TFVars, d_params_template: Params,
                             strict: bool = False) -> Dict[str, Params]:
    """Flat TF vars -> {'params': ..., 'sn': ...} for the FG discriminator."""
    tree = _convert(fg_discriminator_name_map(d_params_template), tf_vars,
                    strict)
    return {"params": tree.get("params", {}), "sn": tree.get("sn", {})}


# ------------------------------------------------------------ Inception-v4

def inception_v4_name_map(final_endpoint: str = "Mixed_7d",
                          num_classes: Optional[int] = None,
                          create_aux_logits: bool = True
                          ) -> Dict[str, Tuple[str, ...]]:
    """{tf_name: our-tree path} for the slim Inception-v4 checkpoint
    (``obj_lib/inception_v4.py``; restored by the reference's perceptual
    scaffold from the stock ImageNet ckpt, ``graph_single.py:505-511``).
    The module's parameter paths mirror the slim scopes 1:1
    (``models/inception_v4.py``),
    so the map is the scope path minus the ``InceptionV4/`` prefix."""
    from ..models.inception_v4 import _AUX, conv_table
    m: Dict[str, Tuple[str, ...]] = {}
    convs = list(conv_table(final_endpoint))
    heads = []
    if num_classes is not None and final_endpoint == "Mixed_7d":
        if create_aux_logits:
            convs += _AUX
            heads.append("AuxLogits/Aux_logits")
        heads.append("Logits/Logits")
    for path, _shape in convs:
        parts = tuple(path.split("/"))
        m[f"InceptionV4/{path}/weights"] = parts + ("weights",)
        for leaf in ("beta", "moving_mean", "moving_variance"):
            m[f"InceptionV4/{path}/BatchNorm/{leaf}"] = \
                parts + ("BatchNorm", leaf)
    for path in heads:
        parts = tuple(path.split("/"))
        m[f"InceptionV4/{path}/weights"] = parts + ("weights",)
        m[f"InceptionV4/{path}/biases"] = parts + ("biases",)
    return m


def convert_inception_v4(tf_vars: TFVars,
                         final_endpoint: str = "Mixed_7d",
                         num_classes: Optional[int] = None,
                         create_aux_logits: bool = True,
                         strict: bool = False) -> Params:
    """Flat slim InceptionV4 vars -> the ``models/inception_v4`` tree."""
    return _convert(inception_v4_name_map(final_endpoint, num_classes,
                                          create_aux_logits), tf_vars, strict)

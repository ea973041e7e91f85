"""Port parity of the TF1 converter
(``sketchyscenecolorization_torch/utils/tf1_converter.py``) against the JAX
package's ``utils/tf1_converter.py``, on the CPU.

- Every name map equals JAX's as a dict: the matching model with each
  fusion, FCN-8s, SegNet (both ``through_intermediate_only``),
  DeepLab-v3+, the BG generator with and without ``multi_residual``, the
  FG generator and discriminator (from the port's and JAX's templates at
  the default ``FGGanConfig``) and Inception-v4 with and without heads;
  its targets are the leaves of the port's module at the default widths
  (built on the meta device: full-size trees are checked at structure
  level, JAX's templates come from ``jax.eval_shape``).
- The same synthetic npz through both converters gives trees equal bit
  for bit; loading the port's tree and exporting it again gives it back.
- Forwards from the same synthetic TF1-shaped npz (seeded, TF layouts:
  deconv filters [kh, kw, out, in], BN variance and factor positive), the
  port from its tree against JAX from its tree, max-abs within the
  existing parity tests' tolerances (measured on the CPU in parentheses):
  RMI ``up`` and ``sigm`` at 48^2, 1e-5 (1.1e-8 with |up| <= 0.036, 6.0e-8);
  the FG generator at 64^2, base 4, 2e-5 (1.2e-5); the discriminator's
  outputs, 1e-4 (8.9e-8), and its committed spectral-norm vectors, 1e-5
  (2.1e-7); the BG generator at 64^2, ngf 4, without ``multi_residual``,
  1e-4 (1.1e-5).  With ``multi_residual`` both float32 outputs are held
  to a float64 evaluation of the port's module within 2e-2, as
  ``tests/test_torch_bg_gan.py`` holds that stack (C2; measured 1.4e-3
  JAX, 1.1e-3 port).
- Twins of the four cases of ``tests/test_converter_semantics.py`` on the
  port's ops, against the same NumPy references, each with its
  corrupted-layout sensitivity check.
- ``load_vgg19_mat`` on a synthetic matconvnet ``.mat``, equal to JAX's
  loader, overlaid onto the FCN-8s tree.
- ``cli_matching --mode train --pretrained_npz`` at 48^2 on the CPU: the
  backbone-only npz is restored, stays frozen through two steps, and the
  text head trains from its fresh init."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from sketchyscenecolorization_tpu import config as jconfig
from sketchyscenecolorization_tpu.models import rmi as j_rmi
from sketchyscenecolorization_tpu.ops.conv import \
    conv2d_transpose as j_conv2d_transpose
from sketchyscenecolorization_tpu.train.bg_gan import \
    build_models as j_bg_models
from sketchyscenecolorization_tpu.train.fg_gan import \
    build_models as j_fg_models
from sketchyscenecolorization_tpu.utils import tf1_converter as jcvt
from sketchyscenecolorization_torch import cli_matching
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.data import matching_dataset as md
from sketchyscenecolorization_torch.models import backbones as tb
from sketchyscenecolorization_torch.models import bg_gan, fg_gan
from sketchyscenecolorization_torch.models.deeplab import FrozenBN
from sketchyscenecolorization_torch.models.gan_layers import commit_sn
from sketchyscenecolorization_torch.models.inception_v4 import InceptionV4
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.ops.lstm import masked_lstm_scan
from sketchyscenecolorization_torch.utils import tf1_converter as tcvt
from sketchyscenecolorization_torch.utils.bridge import (export_jax_tree,
                                                         flatten_tree,
                                                         load_jax_tree)
from sketchyscenecolorization_torch.utils.checkpoint import (
    latest_checkpoint, restore_checkpoint)
from test_converter_semantics import (np_slim_depthwise_3x3_same,
                                      np_tf_conv2d_transpose_same_s2,
                                      np_tf_lstm_dynamic_rnn)
from test_data_and_harness import _write_matching_corpus
from test_torch_train_fg_gan import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_KW = dict(vf_h=6, vf_w=6, H=48, W=48, vocab_size=12, w_emb_dim=16,
                v_emb_dim=16, m_rnn_size=8, w_rnn_size=16, max_len=5)
FG_KW = dict(batch_size=1, image_size=64, vocab_size=10, max_len=4,
             base_channels=4, noise_dim=8, num_classes=5)
BG_KW = dict(batch_size=1, image_size=64, vocab_size=8, max_len=4, ngf=4,
             ndf=4)
# max-abs tolerances of the existing parity tests: tests/test_torch_rmi.py
# (up), tests/test_torch_fg_gan.py (generator), test_torch_gan_layers.py
# (discriminator), test_torch_bg_gan.py (generator, and the float64 bound)
RMI_ATOL = 1e-5
FG_ATOL = 2e-5
DISC_ATOL = 1e-4
BG_ATOL = 1e-4
EXACT_ATOL = 2e-2


# ------------------------------------------------------------------ helpers

def _meta(build):
    with torch.device("meta"):
        return build()


def _structure(module, collection="params"):
    """The module's tree in the JAX layout with ``None`` leaves (works on
    the meta device)."""
    names = (module.named_buffers() if collection == "sn"
             else module.named_parameters())
    tree = {}
    for key, _ in names:
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = None
    return tree


def _paths(tree):
    return {tuple(k.split("/")) for k in flatten_tree(tree)}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _eval_shape_tree(fn, *args):
    return jax.tree.map(lambda _: None, jax.eval_shape(fn, *args))


def _fg_templates(jcfg):
    """JAX's generator and discriminator templates (structure only)."""
    gen, disc = j_fg_models(jcfg)
    s, b = jcfg.image_size, 1
    img = jnp.zeros((b, s, s, 3))
    g = _eval_shape_tree(gen.init, jax.random.PRNGKey(0), img,
                         jnp.zeros((b, jcfg.max_len), jnp.int32),
                         jnp.zeros((b,), jnp.int32),
                         jnp.zeros((b, jcfg.noise_dim)))["params"]
    d = _eval_shape_tree(disc.init, jax.random.PRNGKey(0), img, img,
                         jnp.zeros((b,), jnp.int32))["params"]
    return g, d


def synth_tf_vars(name_map, template, seed, swap=lambda name: False):
    """Seeded TF1-shaped variables for ``name_map``: shapes from the
    port's ``template`` tree (JAX layout), filters that ``swap`` names in
    TF's transposed-conv layout [kh, kw, out, in]; BN gammas near 1,
    variances and factors positive."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, path in name_map.items():
        shape = np.shape(_leaf(template, path))
        if swap(name):
            shape = shape[:2] + (shape[3], shape[2])
        value = np.asarray(rng.randn(*shape)) * 0.05
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("variance", "factor", "moving_variance"):
            value = np.abs(value) + 1.0
        elif leaf in ("gamma", "scale"):
            value = value + 1.0
        out[name] = value.astype(np.float32)
    return out


def _toy_tf_vars(name_map):
    """Distinct small arrays under every name (the converters only rename
    and swap axes, so shapes do not matter): 4-D for the filters."""
    out = {}
    for i, name in enumerate(sorted(name_map)):
        out[name] = (np.arange(24, dtype=np.float32) + 31 * i).reshape(
            2, 3, 2, 2)
    return out


def _assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)


def _check(name, got, want, atol):
    """Max-abs of ``got - want`` within ``atol``; prints it."""
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    print(f"{name}: max-abs {err:.2e} (|want| <= "
          f"{float(np.abs(np.asarray(want)).max()):.3g})")
    assert err <= atol, (name, err)


# ------------------------------------------- name maps, trees, round trips

def _fg_case(block):
    jg, jd = _fg_templates(jconfig.FGGanConfig())
    cfg = tconfig.FGGanConfig()
    if block == "generator":
        port = _meta(lambda: fg_gan.build_generator(cfg))
        return (tcvt.fg_generator_name_map(_structure(port)),
                jcvt.fg_generator_name_map(jg), _paths(_structure(port)))
    port = _meta(lambda: fg_gan.build_discriminator(cfg))
    leaves = ({("params",) + p for p in _paths(_structure(port))}
              | {("sn",) + p for p in _paths(_structure(port, "sn"))})
    return (tcvt.fg_discriminator_name_map(_structure(port)),
            jcvt.fg_discriminator_name_map(jd), leaves)


def _matching_case(kw):
    tcfg, jcfg = tconfig.MatchingConfig(**kw), jconfig.MatchingConfig(**kw)
    port = _meta(lambda: RMI(tcfg))
    return (tcvt.matching_name_map(tcfg), jcvt.matching_name_map(jcfg),
            _paths(_structure(port)))


def _backbone_case(name):
    port = _meta({"fcn8s": tb.FCN8s, "segnet": tb.SegNet,
                  "segnet_full": tb.SegNet,
                  "deeplab_v3plus": tb.DeepLabV3Plus}[name])
    if name == "fcn8s":
        maps = tcvt.fcn8s_name_map(), jcvt.fcn8s_name_map()
    elif name.startswith("segnet"):
        through = name == "segnet"
        maps = (tcvt.segnet_name_map(through), jcvt.segnet_name_map(through))
    else:
        maps = tcvt.deeplab_v3plus_name_map(), jcvt.deeplab_v3plus_name_map()
    return maps + ({(port.SCOPE,) + p for p in _paths(_structure(port))},)


def _inception_case(args):
    port = _meta(lambda: InceptionV4(*args))
    return (tcvt.inception_v4_name_map(*args),
            jcvt.inception_v4_name_map(*args), _paths(_structure(port)))


def _bg_case(multi):
    port = _meta(lambda: bg_gan.build_generator(
        tconfig.BGGanConfig(multi_residual=multi)))
    return (tcvt.bg_generator_name_map(multi),
            jcvt.bg_generator_name_map(multi), _paths(_structure(port)))


MAP_CASES = {
    "matching": lambda: _matching_case({}),
    "matching_use_attn": lambda: _matching_case({"use_attn": True}),
    "matching_recur_attn": lambda: _matching_case(
        {"fusion_type": "RecurAttn"}),
    "fcn8s": lambda: _backbone_case("fcn8s"),
    "segnet": lambda: _backbone_case("segnet"),
    "segnet_full": lambda: _backbone_case("segnet_full"),
    "deeplab_v3plus": lambda: _backbone_case("deeplab_v3plus"),
    "bg_multi_residual": lambda: _bg_case(True),
    "bg": lambda: _bg_case(False),
    "fg_generator": lambda: _fg_case("generator"),
    "fg_discriminator": lambda: _fg_case("discriminator"),
    "inception_heads": lambda: _inception_case(("Mixed_7d", 1001, True)),
    "inception_no_aux": lambda: _inception_case(("Mixed_7d", 1001, False)),
    "inception_base": lambda: _inception_case(("Mixed_7d", None)),
    "inception_perceptual": lambda: _inception_case(("Mixed_5b", None)),
}


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_name_map_equals_jax_and_covers_the_port(case):
    port_map, jax_map, leaves = MAP_CASES[case]()
    assert port_map == jax_map
    mapped = set(port_map.values())
    if case == "segnet":
        # the intermediate exit's layers only (a documented delta)
        assert mapped < leaves
        assert {p[1] for p in leaves - mapped} == {"dec_4", "dec_3",
                                                   "dec_2", "dec_1"}
    elif case == "segnet_full":
        # the reference's decoder has no dec_4/conv3 (commented out
        # upstream); the repaired one has it
        assert mapped < leaves
        assert {p[1:3] for p in leaves - mapped} == {("dec_4", "conv3")}
    else:
        assert mapped == leaves


CONVERTERS = {
    "matching": lambda m, v, t: m.convert_matching(
        v, m.MatchingConfig(**SMALL_KW), strict=True),
    "matching_recur_attn": lambda m, v, t: m.convert_matching(
        v, m.MatchingConfig(**SMALL_KW, fusion_type="RecurAttn"),
        strict=True),
    "fcn8s": lambda m, v, t: m.convert_fcn8s(v, strict=True),
    "segnet": lambda m, v, t: m.convert_segnet(v, strict=True),
    "deeplab_v3plus": lambda m, v, t: m.convert_deeplab_v3plus(
        v, strict=True),
    "bg": lambda m, v, t: m.convert_bg_generator(v, True, strict=True),
    "fg_generator": lambda m, v, t: m.convert_fg_generator(v, t,
                                                           strict=True),
    "fg_discriminator": lambda m, v, t: m.convert_fg_discriminator(
        v, t, strict=True),
    "inception": lambda m, v, t: m.convert_inception_v4(
        v, num_classes=1001, strict=True),
}


def _port_module(case):
    cfg = tconfig.FGGanConfig(**FG_KW)
    if case == "fg_generator":
        return fg_gan.build_generator(cfg)
    return fg_gan.build_discriminator(cfg)


@pytest.mark.parametrize("case", sorted(CONVERTERS))
def test_same_npz_gives_equal_trees(case, tmp_path):
    template = None
    if case.startswith("fg_"):
        template = export_jax_tree(_port_module(case))
    name_map = {
        "matching": lambda: tcvt.matching_name_map(
            tconfig.MatchingConfig(**SMALL_KW)),
        "matching_recur_attn": lambda: tcvt.matching_name_map(
            tconfig.MatchingConfig(**SMALL_KW, fusion_type="RecurAttn")),
        "fcn8s": tcvt.fcn8s_name_map, "segnet": tcvt.segnet_name_map,
        "deeplab_v3plus": tcvt.deeplab_v3plus_name_map,
        "bg": tcvt.bg_generator_name_map,
        "fg_generator": lambda: tcvt.fg_generator_name_map(template),
        "fg_discriminator": lambda: tcvt.fg_discriminator_name_map(template),
        "inception": lambda: tcvt.inception_v4_name_map(num_classes=1001),
    }[case]()
    path = str(tmp_path / "vars.npz")
    np.savez(path, **_toy_tf_vars(name_map))
    got = CONVERTERS[case](tcvt, tcvt.load_tf_vars_npz(path), template)
    want = CONVERTERS[case](jcvt, jcvt.load_tf_vars_npz(path), template)
    _assert_trees_equal(got, want)
    # a missing variable: strict raises on both sides, the rest still maps
    vars_ = tcvt.load_tf_vars_npz(path)
    vars_.pop(sorted(vars_)[0])
    for cvt in (tcvt, jcvt):
        with pytest.raises(KeyError, match="1 variables missing"):
            CONVERTERS[case](cvt, vars_, template)


# -------------------------------------------------- small-size forwards

@pytest.fixture(scope="module")
def matching_pair(tmp_path_factory):
    """(JAX tree, the port's RMI) converted from one synthetic npz at
    48^2."""
    tcfg = tconfig.MatchingConfig(**SMALL_KW)
    model = RMI(tcfg, torch.Generator().manual_seed(0))
    template = export_jax_tree(model)
    name_map = tcvt.matching_name_map(tcfg)
    path = str(tmp_path_factory.mktemp("npz") / "matching.npz")
    np.savez(path, **synth_tf_vars(name_map, template, 0))
    tree = tcvt.convert_matching(tcvt.load_tf_vars_npz(path), tcfg,
                                 strict=True)
    merged = tcvt.merge_converted(template, tree)
    load_jax_tree(model, merged)
    _assert_trees_equal(export_jax_tree(model), merged)
    jtree = jcvt.convert_matching(jcvt.load_tf_vars_npz(path),
                                  jconfig.MatchingConfig(**SMALL_KW),
                                  strict=True)
    _assert_trees_equal(tree, jtree)
    return jtree, model.eval()


def test_rmi_forward_from_converted_npz_matches_jax(matching_pair):
    jtree, model = matching_pair
    rng = np.random.RandomState(1)
    image = rng.uniform(-120, 130, (1, 48, 48, 3)).astype(np.float32)
    words = np.array([[2, 3, 4, 0, 0]], np.int32)
    lens = np.array([3], np.int32)
    want = j_rmi.apply(jax.tree.map(jnp.asarray, jtree),
                       jconfig.MatchingConfig(**SMALL_KW), jnp.asarray(image),
                       jnp.asarray(words), jnp.asarray(lens))
    with torch.no_grad():
        got = model(torch.from_numpy(image), torch.from_numpy(words).long(),
                    torch.from_numpy(lens).long())
    for name in ("up", "sigm"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.isfinite(g).all()
        _check(name, g, w, RMI_ATOL)
    fresh = RMI(tconfig.MatchingConfig(**SMALL_KW),
                torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        base = fresh(torch.from_numpy(image), torch.from_numpy(words).long(),
                     torch.from_numpy(lens).long()).up
    assert not np.allclose(base.numpy(), got.up.numpy())


def _converted_pair(kind, tmp_path, **kw):
    """(JAX variables, the port's module) from one synthetic npz."""
    if kind == "bg":
        tcfg = tconfig.BGGanConfig(**BG_KW, **kw)
        module = bg_gan.build_generator(tcfg)
        template = export_jax_tree(module)
        name_map = tcvt.bg_generator_name_map(tcfg.multi_residual)
        swap = lambda name: "/deconv/filter" in name  # noqa: E731
        convert = lambda cvt, v: cvt.convert_bg_generator(  # noqa: E731
            v, tcfg.multi_residual, strict=True)
    else:
        module = _port_module(kind)
        template = export_jax_tree(module)
        name_map = (tcvt.fg_generator_name_map(template)
                    if kind == "fg_generator"
                    else tcvt.fg_discriminator_name_map(template))
        swap = lambda name: False  # noqa: E731
        convert = lambda cvt, v: CONVERTERS[kind](cvt, v,  # noqa: E731
                                                  template)
    shapes = template
    if kind == "fg_discriminator":
        shapes = {"params": template, "sn": export_jax_tree(module, "sn")}
    path = str(tmp_path / f"{kind}.npz")
    np.savez(path, **synth_tf_vars(name_map, shapes, 3, swap))
    tree = convert(tcvt, tcvt.load_tf_vars_npz(path))
    jtree = convert(jcvt, jcvt.load_tf_vars_npz(path))
    _assert_trees_equal(tree, jtree)
    if kind == "fg_discriminator":
        load_jax_tree(module, tree["params"], sn=tree["sn"])
        _assert_trees_equal({"params": export_jax_tree(module),
                             "sn": export_jax_tree(module, "sn")}, tree)
    else:
        merged = tcvt.merge_converted(template, tree)
        load_jax_tree(module, merged)
        _assert_trees_equal(export_jax_tree(module), merged)
    return jtree, module.eval()


def test_fg_generator_from_converted_npz_matches_jax(tmp_path):
    jtree, model = _converted_pair("fg_generator", tmp_path)
    gen, _ = j_fg_models(jconfig.FGGanConfig(**FG_KW))
    rng = np.random.RandomState(4)
    args = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32),
            np.array([[0, 0, 3, 5], [0, 7, 1, 2]], np.int32),
            np.array([1, 4], np.int32),
            rng.randn(2, 8).astype(np.float32))
    want = jax.jit(gen.apply)({"params": jtree}, *map(jnp.asarray, args))
    with torch.no_grad():
        got = model(torch.from_numpy(args[0]), torch.from_numpy(args[1]).long(),
                    torch.from_numpy(args[2]).long(),
                    torch.from_numpy(args[3]))
    assert np.isfinite(got.numpy()).all()
    _check("fg generator", got.numpy(), want, FG_ATOL)


def test_fg_discriminator_from_converted_npz_matches_jax(tmp_path):
    jvars, model = _converted_pair("fg_discriminator", tmp_path)
    _, disc = j_fg_models(jconfig.FGGanConfig(**FG_KW))
    rng = np.random.RandomState(5)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 1], np.int32)
    (want_out, want_logits), new_vars = jax.jit(
        lambda v, x, lab: disc.apply(v, x, x, lab, mutable=["sn"]))(
        jvars, jnp.asarray(img), jnp.asarray(labels))
    with torch.no_grad(), commit_sn(model):
        out, logits = model(torch.from_numpy(img), torch.from_numpy(img),
                            torch.from_numpy(labels).long())
    _check("disc out", out.numpy(), want_out, DISC_ATOL)
    _check("disc logits", logits.numpy(), want_logits, DISC_ATOL)
    got_sn = flatten_tree(export_jax_tree(model, "sn"))
    for path, leaf in flatten_tree(new_vars["sn"]).items():
        _check(f"sn {path}", got_sn[path], leaf, 1e-5)


@pytest.mark.parametrize("multi_residual", [False, True])
def test_bg_generator_from_converted_npz_matches_jax(tmp_path,
                                                     multi_residual):
    jtree, model = _converted_pair("bg", tmp_path,
                                   multi_residual=multi_residual)
    gen, _ = j_bg_models(jconfig.BGGanConfig(**BG_KW,
                                            multi_residual=multi_residual))
    rng = np.random.RandomState(6)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    tokens = np.array([[0, 3, 5, 7]], np.int32)
    want = jax.jit(gen.apply)({"params": jtree}, jnp.asarray(x),
                              jnp.asarray(tokens))
    tokens_t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        got = model(torch.from_numpy(x), tokens_t)
        exact = model.double()(torch.from_numpy(x).double(), tokens_t)
    for g, w, e in zip(got, want, exact):
        assert np.isfinite(g.numpy()).all()
        if multi_residual:
            for side, f32 in (("jax", np.asarray(w)), ("port", g.numpy())):
                _check(f"bg {side} vs float64", f32, e.numpy(), EXACT_ATOL)
        else:
            _check("bg", g.numpy(), w, BG_ATOL)


# ------------------------- twins of tests/test_converter_semantics.py

def test_deconv_filter_swap_value_parity():
    rng = np.random.RandomState(0)
    cin = cout = 2                      # square: a missing swap passes shapes
    x = rng.randn(1, 3, 3, cin)
    w_tf = rng.randn(4, 4, cout, cin)   # TF layout [kh, kw, out, in]
    expect = np_tf_conv2d_transpose_same_s2(x, w_tf)

    def run(w_hwio):
        deconv = load_jax_tree(bg_gan.Deconv(cin, cout),
                               {"filter": w_hwio.astype(np.float32)})
        with torch.no_grad():
            return deconv(torch.from_numpy(x.astype(np.float32))).numpy()
    got = run(tcvt.swap_deconv_filter(w_tf))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    # the op itself, against JAX's on the same HWIO kernel
    np.testing.assert_allclose(got, np.asarray(j_conv2d_transpose(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(jcvt.swap_deconv_filter(w_tf), jnp.float32))),
        rtol=0, atol=1e-5)
    # sensitivity: the unswapped filter changes the output
    assert np.abs(run(w_tf) - expect).max() > 1e-3


def test_lstm_kernel_gate_order_and_forget_bias():
    rng = np.random.RandomState(1)
    d, hid, b, t = 3, 4, 2, 5
    kernel = rng.randn(d + hid, 4 * hid) * 0.7
    bias = rng.randn(4 * hid) * 0.3
    xs = rng.randn(b, t, d)
    seq_len = np.array([3, 5])
    expect_y, (expect_c, expect_h) = np_tf_lstm_dynamic_rnn(
        xs, kernel, bias, seq_len, hid)

    def run(k):
        with torch.no_grad():
            return masked_lstm_scan(
                torch.tensor(xs, dtype=torch.float32),
                torch.from_numpy(seq_len),
                torch.tensor(k, dtype=torch.float32),
                torch.tensor(bias, dtype=torch.float32), hid)
    got_y, (got_c, got_h) = run(kernel)
    for got, want in ((got_y, expect_y), (got_h, expect_h),
                      (got_c, expect_c)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    perm = np.concatenate([kernel[:, 2 * hid:3 * hid], kernel[:, hid:2 * hid],
                           kernel[:, :hid], kernel[:, 3 * hid:]], axis=1)
    assert np.abs(run(perm)[0].numpy() - expect_y).max() > 1e-3


def test_frozen_bn_factor_division():
    rng = np.random.RandomState(2)
    c = 5
    x = rng.randn(1, 2, 2, c)
    mean, var = rng.randn(c), rng.rand(c) + 0.5
    beta, gamma = rng.randn(c), rng.randn(c)
    factor = np.array([2.5])
    expect = gamma * (x - mean / factor) / np.sqrt(var / factor + 0.001) \
        + beta
    bn = load_jax_tree(FrozenBN(c), {
        k: v.astype(np.float32) for k, v in dict(
            beta=beta, gamma=gamma, mean=mean, variance=var,
            factor=factor).items()})
    with torch.no_grad():
        got = bn(torch.tensor(x, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)
    no_div = gamma * (x - mean) / np.sqrt(var + 0.001) + beta
    assert np.abs(no_div - expect).max() > 1e-3


def test_separable_depthwise_pointwise_split():
    """DeepLab-v3+'s separable conv through the bridge: slim's depthwise
    [3, 3, in, 1] per channel, then the pointwise [1, 1, in, out], each
    followed by its frozen BN and a ReLU."""
    rng = np.random.RandomState(3)
    cin, cout, rate = 3, 2, 2
    x = rng.randn(1, 6, 6, cin)
    w_dw = rng.randn(3, 3, cin, 1)
    w_pw = rng.randn(1, 1, cin, cout)

    def bn(c):
        return {"beta": rng.randn(c), "gamma": rng.rand(c) + 0.5,
                "mean": rng.randn(c), "variance": rng.rand(c) + 0.5}
    bns = {"depthwise": bn(cin), "pointwise": bn(cout)}

    def np_bn(y, p):
        return np.maximum((y - p["mean"]) / np.sqrt(p["variance"] + 1e-5)
                          * p["gamma"] + p["beta"], 0.0)
    expect = np_bn(np_bn(np_slim_depthwise_3x3_same(x, w_dw, rate),
                         bns["depthwise"]) @ w_pw[0, 0], bns["pointwise"])

    def run(dw):
        tree = {name: {"DW": w, "bn": bns[name]} for name, w in
                (("depthwise", dw), ("pointwise", w_pw))}
        sep = load_jax_tree(tb.SepConv(cin, cout), jax.tree.map(
            lambda v: np.asarray(v, np.float32), tree))
        with torch.no_grad():
            return sep(torch.tensor(x, dtype=torch.float32), rate=rate)
    np.testing.assert_allclose(run(w_dw).numpy(), expect, rtol=1e-4,
                               atol=1e-5)
    assert np.abs(run(w_dw[:, :, [1, 0, 2], :]).numpy() - expect).max() \
        > 1e-3


# ------------------------------------------------------------- VGG-19 .mat

def test_vgg19_mat_loader_and_overlay(tmp_path):
    layer_names, conv_shapes = [], {}
    for spec in tb.VGG_LAYERS:
        name = spec[0]
        if name.startswith("conv"):
            layer_names += [name, "relu" + name[4:]]
            conv_shapes[name] = spec[1:]
        else:
            layer_names.append(name)
    rng = np.random.RandomState(0)
    cells = np.empty((1, len(layer_names)), object)
    expected = {}
    for i, name in enumerate(layer_names):
        if name.startswith("conv"):
            cin, cout = conv_shapes[name]
            k = rng.randn(3, 3, cin, cout).astype(np.float32)  # [w,h,in,out]
            b = rng.randn(1, cout).astype(np.float32)
            expected[name] = (np.transpose(k, (1, 0, 2, 3)), b.reshape(-1))
            w = np.empty((1, 2), object)
            w[0, 0], w[0, 1] = k, b
            st = np.zeros((1, 1), dtype=[("weights", object),
                                         ("type", object)])
            st[0, 0]["weights"] = w
            st[0, 0]["type"] = np.array(["conv"])
        else:
            st = np.zeros((1, 1), dtype=[("type", object)])
            st[0, 0]["type"] = np.array([name[:4]])
        cells[0, i] = st
    mat_path = str(tmp_path / "vgg19.mat")
    scipy.io.savemat(mat_path, {"layers": cells})

    vgg = tcvt.load_vgg19_mat(mat_path)
    jvgg = jcvt.load_vgg19_mat(mat_path)
    assert set(vgg) == set(jvgg) == set(conv_shapes)
    for name, (dw, bias) in vgg.items():
        np.testing.assert_array_equal(dw, expected[name][0])
        np.testing.assert_array_equal(bias, expected[name][1])
        np.testing.assert_array_equal(dw, jvgg[name][0])
    overlay = tcvt.vgg19_to_fcn8s(vgg)
    _assert_trees_equal(overlay, jcvt.vgg19_to_fcn8s(jvgg))
    # onto the (meta) FCN-8s: every overlaid leaf is one of its leaves,
    # with its shape after the bridge's layout change
    params = dict(_meta(tb.FCN8s).named_parameters())
    for path, leaf in flatten_tree(overlay["FCN_8s"]).items():
        key = path.replace("/", ".")
        want = tuple(params[key].shape)
        got = leaf.shape if leaf.ndim == 1 else tuple(
            np.transpose(leaf, (3, 2, 0, 1)).shape)
        assert got == want, path


# ------------------------------------------- cli_matching --pretrained_npz

def test_cli_matching_trains_from_pretrained_npz(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(md, "IMAGE_SIZE", md.IMAGE_SIZE)   # restored after
    _write_matching_corpus(tmp_path)
    os.replace(tmp_path / "caps.json",
               tmp_path / "sentence_instance_train.json")
    args = ["--mode", "train", "--data_base_dir", str(tmp_path),
            "--captions_base_dir", str(tmp_path),
            "--vocab_path", os.path.join(ROOT, "data", "match_vocab.txt"),
            "--image_size", "48", "--model_scale", "0.016",
            "--run_dir", str(tmp_path / "run"), "--device", "cpu",
            "--max_iteration", "2"]
    cfg = tconfig.MatchingConfig(H=48, W=48, vf_h=6, vf_w=6, w_emb_dim=16,
                                 v_emb_dim=16, m_rnn_size=8, w_rnn_size=16,
                                 max_iters=2)
    fresh = RMI(cfg, torch.Generator().manual_seed(0))
    template = export_jax_tree(fresh)
    backbone = {n: p for n, p in tcvt.matching_name_map(cfg).items()
                if p[0] == "ResNet"}
    npz = str(tmp_path / "backbone.npz")
    tf_vars = synth_tf_vars(backbone, template, 7)
    np.savez(npz, **tf_vars)
    assert cli_matching.main(args + ["--pretrained_npz", npz]) == 0
    assert "restored pretrained backbone" in capsys.readouterr().out
    step, path = latest_checkpoint(str(tmp_path / "run" / "snapshots"))
    assert step == 2
    saved = restore_checkpoint(path)["model"]
    for name, tree_path in backbone.items():
        got = saved[".".join(tree_path)].numpy()
        want = tf_vars[name]
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(got, want, err_msg=name)
    init = fresh.state_dict()
    for key, value in saved.items():
        if key.startswith("text_sketchyscene."):
            assert not torch.equal(value, init[key]), key

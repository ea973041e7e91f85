"""Port parity of the bfloat16 policy (``ops/conv.py:compute_dtype_scope``)
against the JAX package's (``sketchyscenecolorization_tpu/ops/conv.py:38-157``,
``tests/test_dtype_policy.py``).  The same NumPy inputs and JAX's own
weights (through the bridge) go to both sides; JAX runs on the CPU as its
tests run it.  torch runs on one thread.

(a) Ops and dtype trails: under the scope ``conv2d``, ``pad1_conv4`` and
``conv2d_transpose`` return bf16 and the three norms return at their input
dtype, as in JAX, each element within one bf16 ulp of JAX's
(``|d| <= 2^-8 |ref| + 1e-6``).  The dtype of every module's output along
the FG generator, the BG generator and ``extract_visual`` (flax's
``capture_intermediates`` against forward hooks on the port's modules of
the same names) equals JAX's.

(b) Models and engines, at the sizes of ``tests/test_dtype_policy.py``:
port bf16 against JAX f32 no worse than 1.5 x JAX's own bf16-against-f32
error, in mean-abs and in max-abs, with JAX's correlation bounds (FG and
matching > 0.98, the deep BG batch-norm stack > 0.8); port bf16 against
JAX bf16 within 1.5 x that same max-abs: the two accumulate the bf16 convs
in f32 in other orders, round some values to the neighbouring bf16, and
the batch norms amplify those one-ulp steps as they amplify bf16's own
rounding (measured max-abs port bf16 against JAX bf16: FG generator 0.023,
BG generator 1.6 with JAX's own bf16 error 0.18 mean-abs on outputs in
[-1, 1]).  The text fusions run
f32 inside a bf16 model: a bf16 tensor given to the kernel's wrapper
raises."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchyscenecolorization_tpu import config as jconfig
from sketchyscenecolorization_tpu.models import rmi as j_rmi
from sketchyscenecolorization_tpu.models.bg_gan import \
    ResidualGenerator as JaxResidualGenerator
from sketchyscenecolorization_tpu.models.fg_gan import \
    MRUGenerator as JaxMRUGenerator
from sketchyscenecolorization_tpu.ops import conv as j_conv
from sketchyscenecolorization_tpu.ops import norm as j_norm
from sketchyscenecolorization_tpu.pipeline import engines as j_eng
from sketchyscenecolorization_tpu.train.bg_gan import \
    build_models as j_bg_models
from sketchyscenecolorization_tpu.train.fg_gan import \
    build_models as j_fg_models
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.models import bg_gan, fg_gan
from sketchyscenecolorization_torch.models.rmi import RMI
from sketchyscenecolorization_torch.ops import conv as t_conv
from sketchyscenecolorization_torch.ops import norm as t_norm
from sketchyscenecolorization_torch.ops.mlstm import mlstm_cuda
from sketchyscenecolorization_torch.pipeline import engines as t_eng
from sketchyscenecolorization_torch.utils.bridge import load_jax_tree
from test_torch_session import JaxNoise

ULP, ULP_FLOOR = 2.0 ** -8, 1e-6
ERR_RATIO = 1.5
PIXEL_MU = np.array((104.00698793, 116.66876762, 122.67891434))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corr(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.corrcoef(a, b)[0, 1])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_ulp(got, want, what):
    got, want = _f32(got), _f32(want)
    excess = np.abs(got - want) - (ULP * np.abs(want) + ULP_FLOOR)
    print(f"{what}: max-abs {np.abs(got - want).max():.3g}, "
          f"{int((got != want).sum())} of {want.size} elements differ")
    assert excess.max() <= 0, (what, float(excess.max()))


# ----------------------------------------------------------------- (a) ops

def test_scope_casts_and_restores():
    x = torch.ones(1, 4, 4, 3)
    w = torch.ones(2, 3, 3, 3)
    with t_conv.compute_dtype_scope("bfloat16"):
        assert t_conv.scope_dtype() is torch.bfloat16
        assert t_conv.conv2d(x, w).dtype == torch.bfloat16
        with t_conv.compute_dtype_scope("float32"):
            assert t_conv.conv2d(x, w).dtype == torch.float32
        assert t_conv.scope_dtype() is torch.bfloat16
    assert t_conv.scope_dtype() is None
    assert t_conv.conv2d(x, w).dtype == torch.float32
    with pytest.raises(ValueError, match="compute dtype"):
        with t_conv.compute_dtype_scope("float16"):
            pass
    with pytest.raises(RuntimeError):
        with t_conv.compute_dtype_scope("bfloat16"):
            raise RuntimeError("inside")
    assert t_conv.scope_dtype() is None


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("op", ["conv2d", "conv2d_s2_rate1", "atrous",
                                "pad1_conv4", "conv2d_transpose",
                                "conv2d_transpose_s8"])
def test_bf16_convs_match_jax(op):
    rng = np.random.RandomState(0)
    x = _rand(rng, 2, 12, 12, 6)
    k, stride, rate = {"conv2d": (3, 1, 1), "conv2d_s2_rate1": (4, 2, 1),
                       "atrous": (3, 1, 2), "pad1_conv4": (4, 2, 1),
                       "conv2d_transpose": (4, 2, 1),
                       "conv2d_transpose_s8": (16, 8, 1)}[op]
    w = _rand(rng, k, k, 6, 5, scale=0.2)                      # HWIO
    xt = torch.from_numpy(x)
    with j_conv.compute_dtype_scope("bfloat16"), \
            t_conv.compute_dtype_scope("bfloat16"):
        if op.startswith("conv2d_transpose"):
            want = j_conv.conv2d_transpose(jnp.asarray(x), jnp.asarray(w),
                                           stride=stride)
            got = t_conv.conv2d_transpose(
                xt, torch.from_numpy(w.transpose(2, 3, 0, 1).copy()),
                stride=stride)
        elif op == "pad1_conv4":
            want = j_conv.pad1_conv4(jnp.asarray(x), jnp.asarray(w), stride)
            got = t_conv.pad1_conv4(
                xt, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), stride)
        else:
            want = j_conv.conv2d(jnp.asarray(x), jnp.asarray(w),
                                 stride=stride, rate=rate)
            got = t_conv.conv2d(
                xt, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                stride=stride, rate=rate)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape
    _within_ulp(got, want, op)


@pytest.mark.parametrize("norm", ["batch_stats", "conditional", "l2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_norms_keep_the_input_dtype(norm, dtype):
    """Statistics in f32, the result at the input dtype."""
    rng = np.random.RandomState(1)
    x32 = _rand(rng, 3, 5, 4, 6, scale=2.0) + 1.0
    jx = jnp.asarray(x32).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    offset, scale = _rand(rng, 6), _rand(rng, 6) + 1.0
    tables = (_rand(rng, 4, 6), _rand(rng, 4, 6) + 1.0)
    labels = np.array([0, 3, 1], np.int32)
    if norm == "batch_stats":
        want = j_norm.batch_stats_norm(jx, jnp.asarray(offset),
                                       jnp.asarray(scale))
        got = t_norm.batch_stats_norm(tx, torch.from_numpy(offset),
                                      torch.from_numpy(scale))
    elif norm == "conditional":
        want = j_norm.conditional_batch_stats_norm(
            jx, jnp.asarray(labels), *map(jnp.asarray, tables))
        got = t_norm.conditional_batch_stats_norm(
            tx, torch.from_numpy(labels).long(), *map(torch.from_numpy,
                                                      tables))
    else:
        want = j_norm.l2_normalize(jx, axis=-1)
        got = t_norm.l2_normalize(tx, dim=-1)
    assert str(want.dtype) == dtype and got.dtype == getattr(torch, dtype)
    _within_ulp(got, want, f"{norm} {dtype}")


def _flax_trail(intermediates):
    """{"a/b": [dtype, ...]} of every module's __call__ output."""
    trail = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            flax.core.unfreeze(intermediates))[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        cut = keys.index("__call__")
        trail.setdefault("/".join(keys[:cut]), []).append(str(leaf.dtype))
    return trail


def _port_trail(model, run):
    """{"a/b": [dtype, ...]} of every submodule's forward output."""
    trail, hooks = {}, []
    for name, module in model.named_modules():
        def hook(_, __, out, name=name):
            outs = out if isinstance(out, (list, tuple)) else [out]
            trail.setdefault(name.replace(".", "/"), []).extend(
                str(o.dtype).replace("torch.", "") for o in outs
                if isinstance(o, torch.Tensor))
        hooks.append(module.register_forward_hook(hook))
    try:
        with torch.no_grad(), t_conv.compute_dtype_scope("bfloat16"):
            out = run()
    finally:
        for h in hooks:
            h.remove()
    return trail, out


def _compare_trails(jax_trail, port_trail, min_common):
    common = sorted(set(jax_trail) & set(port_trail))
    assert len(common) >= min_common, (len(common), sorted(jax_trail)[:10])
    for name in common:
        assert port_trail[name] == jax_trail[name], name
    dtypes = {d for name in common for d in port_trail[name]}
    print(f"{len(common)} modules compared, dtypes {sorted(dtypes)}")
    return dtypes


def _fg_inputs():
    rng = np.random.RandomState(0)
    sketch = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    tokens = np.array([[0, 0, 3, 4, 5, 2], [0, 0, 0, 0, 7, 1]], np.int32)
    labels = np.array([1, 3], np.int32)
    noise = rng.randn(2, 256).astype(np.float32)
    return sketch, tokens, labels, noise


@pytest.fixture(scope="module")
def fg_models():
    """JAX's MRU generator of ``tests/test_dtype_policy.py:48`` and the
    port's loaded from its variables."""
    model = JaxMRUGenerator(num_classes=5, vocab_size=12, size=8)
    args = _fg_inputs()
    variables = model.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))
    port = fg_gan.MRUGenerator(num_classes=5, vocab_size=12, size=8,
                               image_size=32)
    load_jax_tree(port, jax.tree.map(np.asarray, variables["params"]))
    return model, variables, port.eval()


@pytest.fixture(scope="module")
def bg_models():
    model = JaxResidualGenerator(ngf=8, vocab_size=10, multi_residual=True)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    tokens = np.array([[0, 0, 3, 4, 5, 2, 1, 7]], np.int32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(tokens))
    port = bg_gan.ResidualGenerator(ngf=8, vocab_size=10,
                                    multi_residual=True)
    load_jax_tree(port, jax.tree.map(np.asarray, variables["params"]))
    return model, variables, port.eval(), x, tokens


def test_fg_generator_dtype_trail_matches_jax(fg_models):
    model, variables, port = fg_models
    args = _fg_inputs()
    with j_conv.compute_dtype_scope("bfloat16"):
        _, state = model.apply(variables, *map(jnp.asarray, args),
                               capture_intermediates=True)
    targs = [torch.from_numpy(a) for a in args]
    targs[1], targs[2] = targs[1].long(), targs[2].long()
    trail, out = _port_trail(port, lambda: port(*targs))
    assert out.dtype == torch.bfloat16
    dtypes = _compare_trails(_flax_trail(state["intermediates"]), trail, 60)
    assert "bfloat16" in dtypes


def test_bg_generator_dtype_trail_matches_jax(bg_models):
    model, variables, port, x, tokens = bg_models
    with j_conv.compute_dtype_scope("bfloat16"):
        _, state = model.apply(variables, jnp.asarray(x), jnp.asarray(tokens),
                               capture_intermediates=True)
    trail, (out, reg) = _port_trail(port, lambda: port(
        torch.from_numpy(x), torch.from_numpy(tokens).long()))
    assert out.dtype == reg.dtype == torch.bfloat16
    _compare_trails(_flax_trail(state["intermediates"]), trail, 80)


MATCH_KW = dict(vf_h=8, vf_w=8, H=64, W=64, vocab_size=12, w_emb_dim=16,
                v_emb_dim=16, m_rnn_size=8, w_rnn_size=16, max_len=5)


@pytest.fixture(scope="module")
def matching_models():
    """JAX's matching params of ``tests/test_dtype_policy.py:158`` and the
    port's f32 and bf16 ``RMI`` on them."""
    cfg = jconfig.MatchingConfig(**MATCH_KW)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: j_rmi.init_params(k, cfg))(jax.random.PRNGKey(0)))
    ports = {dt: load_jax_tree(RMI(tconfig.MatchingConfig(
        **MATCH_KW, compute_dtype=dt)), params).eval()
        for dt in ("float32", "bfloat16")}
    return cfg, params, ports


def _sketch_image():
    sk = np.full((64, 64, 3), 255, np.uint8)
    sk[10:30, 10:40] = 0
    return sk, (sk.astype(np.float32) - PIXEL_MU).astype(np.float32)


def test_extract_visual_dtype_trail_matches_jax(matching_models):
    """Backbone output, projection output and result of ``extract_visual``
    under bf16 (JAX ``rmi.py:259-274``): DeepLab-v2 ends in f32 (the
    frozen BN's f32 parameters), the projection conv's f32 bias brings it
    back to f32, and the result is f32."""
    cfg, params, ports = matching_models
    _, image = _sketch_image()
    jp = jax.tree.map(jnp.asarray, params)
    scope, _, bb_apply, _ = j_rmi._backbone(cfg)
    with j_conv.compute_dtype_scope("bfloat16"):
        feat = bb_apply(jp[scope], jnp.asarray(image[None]), None)
        proj = jp["text_sketchyscene"]["visual_feat_projection"]
        visual = j_conv.conv2d(feat, proj["DW"]) + proj["biases"]
    want = [str(feat.dtype), str(visual.dtype), str(
        j_rmi.extract_visual(jp, dataclasses.replace(
            cfg, compute_dtype="bfloat16"), jnp.asarray(image[None])).dtype)]
    port = ports["bfloat16"]
    trail, out = _port_trail(port, lambda: port.extract_visual(
        torch.from_numpy(image[None])))
    got = [trail["ResNet"][0], None, str(out.dtype).replace("torch.", "")]
    with torch.no_grad(), t_conv.compute_dtype_scope("bfloat16"):
        feat_t = port.ResNet(torch.from_numpy(image[None]))
        p = port.text_sketchyscene.visual_feat_projection
        got[1] = str((t_conv.conv2d(feat_t, p.DW) + p.biases).dtype) \
            .replace("torch.", "")
    assert got == want, (got, want)


# ----------------------------------------------------- (b) models, engines

def _error_budget(what, port16, jax16, jax32):
    """Port bf16 against JAX f32 no worse than ERR_RATIO x JAX's own
    bf16-against-f32 error, in mean-abs and in max-abs; port bf16 against
    JAX bf16 (two bf16 evaluations that round at different places) within
    ERR_RATIO x that same max-abs."""
    port16, jax16, jax32 = _f32(port16), _f32(jax16), _f32(jax32)
    own, own_max = np.abs(jax16 - jax32).mean(), np.abs(jax16 - jax32).max()
    ours, ours_max = np.abs(port16 - jax32).mean(), np.abs(port16 - jax32).max()
    vs16 = np.abs(port16 - jax16).max()
    print(f"{what}: port bf16 vs JAX f32 mean-abs {ours:.4g} max-abs "
          f"{ours_max:.4g}; JAX bf16 vs f32 {own:.4g} / {own_max:.4g}; port "
          f"bf16 vs JAX bf16 max-abs {vs16:.4g}")
    assert np.isfinite(port16).all()
    assert ours <= ERR_RATIO * own, (ours, own)
    assert ours_max <= ERR_RATIO * own_max, (ours_max, own_max)
    assert vs16 <= ERR_RATIO * own_max, (vs16, own_max)
    return port16


def test_fg_generator_bf16_forward_matches_jax(fg_models):
    model, variables, port = fg_models
    args = _fg_inputs()
    jargs = list(map(jnp.asarray, args))
    f32 = model.apply(variables, *jargs)
    with j_conv.compute_dtype_scope("bfloat16"):
        j16 = model.apply(variables, *jargs)
    targs = [torch.from_numpy(a) for a in args]
    targs[1], targs[2] = targs[1].long(), targs[2].long()
    with torch.no_grad(), t_conv.compute_dtype_scope("bfloat16"):
        t16 = port(*targs)
    assert t16.dtype == torch.bfloat16
    out = _error_budget("FG generator", t16, j16, f32)
    assert _corr(_f32(f32), out) > 0.99


def test_bg_generator_bf16_forward_matches_jax(bg_models):
    model, variables, port, x, tokens = bg_models
    f32, _ = model.apply(variables, jnp.asarray(x), jnp.asarray(tokens))
    with j_conv.compute_dtype_scope("bfloat16"):
        j16, _ = model.apply(variables, jnp.asarray(x), jnp.asarray(tokens))
    with torch.no_grad(), t_conv.compute_dtype_scope("bfloat16"):
        t16, _ = port(torch.from_numpy(x), torch.from_numpy(tokens).long())
    out = _error_budget("BG generator", t16, j16, f32)
    assert _corr(_f32(f32), out) > 0.8
    np.testing.assert_allclose(out.std(), _f32(f32).std(), rtol=0.1)


def _fg_engine_outputs():
    cfg = jconfig.FGGanConfig(image_size=32, vocab_size=12, max_len=6,
                              base_channels=8, num_classes=5)
    gen, _ = j_fg_models(cfg)
    s = cfg.image_size
    params = gen.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, s, s, 3), jnp.float32),
                      jnp.zeros((1, cfg.max_len), jnp.int32),
                      jnp.zeros((1,), jnp.int32),
                      jnp.zeros((1, cfg.noise_dim), jnp.float32))["params"]
    vocab = {"<pad>": 0, "<unk>": 1, "red": 2}
    sketch = np.random.RandomState(0).uniform(-1, 1, (2, s, s, 3)) \
        .astype(np.float32)
    outs = {}
    for dt in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(cfg, compute_dtype=dt)
        outs[("jax", dt)] = j_eng.FGColorizeEngine(
            jcfg, params, vocab, seed=0).colorize_batch(sketch, [1, 3], "red")
        tcfg = tconfig.FGGanConfig(**dataclasses.asdict(jcfg))
        model = load_jax_tree(fg_gan.build_generator(tcfg),
                              jax.tree.map(np.asarray, params))
        eng = t_eng.FGColorizeEngine(tcfg, model, vocab, seed=0,
                                     device="cpu")
        eng.noise_source = JaxNoise(0, tcfg.noise_dim)
        outs[("port", dt)] = eng.colorize_batch(sketch, [1, 3], "red")
    return {k: np.asarray(v, np.float32) / 255.0 for k, v in outs.items()}


def _bg_engine_outputs():
    cfg = jconfig.BGGanConfig(image_size=64, vocab_size=10, ngf=8, ndf=8)
    gen, _ = j_bg_models(cfg)
    params = gen.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 64, 64, 3), jnp.float32),
                      jnp.zeros((1, cfg.max_len), jnp.int32))["params"]
    vocab = {"<pad>": 0, "<unk>": 1, "blue": 2}
    img = np.random.RandomState(0).randint(0, 255, (64, 64, 3)) \
        .astype(np.uint8)
    outs = {}
    for dt in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(cfg, compute_dtype=dt)
        outs[("jax", dt)] = j_eng.BGColorizeEngine(
            jcfg, params, vocab).colorize(img, "blue")[0]
        tcfg = tconfig.BGGanConfig(**dataclasses.asdict(jcfg))
        model = load_jax_tree(bg_gan.build_generator(tcfg),
                              jax.tree.map(np.asarray, params))
        outs[("port", dt)] = t_eng.BGColorizeEngine(
            tcfg, model, vocab, device="cpu").colorize(img, "blue")[0]
    return {k: v.astype(np.float32) / 255.0 for k, v in outs.items()}


def _matching_engine_outputs(matching_models):
    cfg, params, ports = matching_models
    vocab = {"<pad>": 0, "<unk>": 1, "the": 2, "bus": 3}
    _, image = _sketch_image()
    words = np.zeros((1, 5), np.int32)
    words[0, :2] = [2, 3]
    lens = np.array([2], np.int32)
    outs = {}
    for dt in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(cfg, compute_dtype=dt)
        eng = j_eng.MatchingEngine(jcfg, params, vocab)
        visual = eng._extract(params, jnp.asarray(image[None]))
        outs[("jax", dt)] = np.asarray(eng._fuse(
            params, visual, jnp.asarray(words), jnp.asarray(lens)))
        teng = t_eng.MatchingEngine(ports[dt].cfg, ports[dt], vocab,
                                    device="cpu")
        visual = teng.extract_visual_dev(torch.from_numpy(image[None]))
        outs[("port", dt)] = teng.fuse_logits(visual, words, lens).numpy()
    return outs


@pytest.mark.parametrize("engine", ["fg", "bg", "matching"])
def test_engines_serve_the_config_dtype(engine, matching_models):
    """Each engine runs its model under its config's dtype (JAX
    ``tests/test_dtype_policy.py:100-200``): the port's bf16 engine against
    its f32 one and against JAX's engines, from the same weights."""
    outs = {"fg": _fg_engine_outputs, "bg": _bg_engine_outputs,
            "matching": lambda: _matching_engine_outputs(matching_models)
            }[engine]()
    np.testing.assert_allclose(outs[("port", "float32")],
                               outs[("jax", "float32")], rtol=0,
                               atol=1 / 255 + 1e-6 if engine != "matching"
                               else 1e-5)
    port16 = _error_budget(f"{engine} engine", outs[("port", "bfloat16")],
                           outs[("jax", "bfloat16")],
                           outs[("jax", "float32")])
    bound = 0.8 if engine == "bg" else 0.98
    assert _corr(outs[("port", "float32")], port16) > bound
    assert _corr(outs[("jax", "float32")], port16) > bound


def test_kernel_wrapper_refuses_bf16():
    """The text fusions hand the kernel f32 under the bf16 scope; the
    kernel's wrapper takes f32 only and never casts: a bf16 operand raises
    ``TypeError`` before anything else is checked."""
    args = [torch.zeros(1, 4, 16), torch.zeros(1, 2, 16), torch.zeros(4, 16),
            torch.ones(1, 2, dtype=torch.int32)]
    for i in range(3):
        bad = list(args)
        bad[i] = bad[i].to(torch.bfloat16)
        with pytest.raises(TypeError, match="float32"):
            mlstm_cuda(*bad)

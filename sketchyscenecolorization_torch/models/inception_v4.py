"""Inception-v4, the complete network, and the FG GAN perceptual loss
(``sketchyscenecolorization_tpu/models/inception_v4.py``; reference
``obj_lib/inception_v4.py`` (slim) + ``obj_lib/inception_utils.py``).

slim's arg scope puts a batch norm after every conv: no gamma, eps 1e-3,
the moving statistics at inference (not the port's batch-stats norm of
``ops/norm.py``), then ReLU.  ``slim.avg_pool2d`` with SAME padding leaves
the padding out of its count.  Every stride-2 conv and pool of the network
is VALID, and every SAME one has stride 1 and an odd kernel, so no TF SAME
padding here is asymmetric (``conv_bn_relu`` pads asymmetrically all the
same where a table would ask for it).

The FG GAN consumes the stem through ``Mixed_5b`` for its perceptual loss
(``graph_single.py:467-511``: endpoints [Conv2d_2a_3x3, Mixed_4a,
Mixed_5b], mean-L1 over the two images resized to 299 and mapped to
[0, 1]).  The full network has the AuxLogits head off Mixed_6h and the
Logits head with dropout keep 0.8 at train time (``inception_v4.py:
255-318``).

Parameters are named on the slim scope paths
(``Mixed_5b/Branch_0/Conv2d_0a_1x1/{weights, BatchNorm/beta,
BatchNorm/moving_mean, BatchNorm/moving_variance}``, the heads'
``weights`` [fan_in, n] and ``biases``), as the JAX tree is, so
``utils/bridge.py`` maps it 1:1 (kernels OIHW here, HWIO in JAX).
Activations are NHWC at every public function; the module computes in
NCHW inside.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import same_pads
from ..ops.image import resize_bilinear_half_pixel
from ..parallel.mesh import shard_mean
from .gan_layers import truncated_normal

BN_EPS = 1e-3
Table = List[Tuple[str, Tuple[int, int, int, int]]]

# Every conv in the network: scope path -> (kh, kw, cin, cout), as in JAX
# (derived from inception_v4.py:34-253).
_STEM: Table = [
    ("Conv2d_1a_3x3", (3, 3, 3, 32)),
    ("Conv2d_2a_3x3", (3, 3, 32, 32)),
    ("Conv2d_2b_3x3", (3, 3, 32, 64)),
    ("Mixed_3a/Branch_1/Conv2d_0a_3x3", (3, 3, 64, 96)),
    ("Mixed_4a/Branch_0/Conv2d_0a_1x1", (1, 1, 160, 64)),
    ("Mixed_4a/Branch_0/Conv2d_1a_3x3", (3, 3, 64, 96)),
    ("Mixed_4a/Branch_1/Conv2d_0a_1x1", (1, 1, 160, 64)),
    ("Mixed_4a/Branch_1/Conv2d_0b_1x7", (1, 7, 64, 64)),
    ("Mixed_4a/Branch_1/Conv2d_0c_7x1", (7, 1, 64, 64)),
    ("Mixed_4a/Branch_1/Conv2d_1a_3x3", (3, 3, 64, 96)),
    ("Mixed_5a/Branch_0/Conv2d_1a_3x3", (3, 3, 192, 192)),
]


def _block_a(scope: str) -> Table:
    # inception_v4.py:34-52 (input 35x35x384, output 384)
    return [(f"{scope}/Branch_0/Conv2d_0a_1x1", (1, 1, 384, 96)),
            (f"{scope}/Branch_1/Conv2d_0a_1x1", (1, 1, 384, 64)),
            (f"{scope}/Branch_1/Conv2d_0b_3x3", (3, 3, 64, 96)),
            (f"{scope}/Branch_2/Conv2d_0a_1x1", (1, 1, 384, 64)),
            (f"{scope}/Branch_2/Conv2d_0b_3x3", (3, 3, 64, 96)),
            (f"{scope}/Branch_2/Conv2d_0c_3x3", (3, 3, 96, 96)),
            (f"{scope}/Branch_3/Conv2d_0b_1x1", (1, 1, 384, 96))]


_REDUCTION_A: Table = [  # inception_v4.py:55-72 (384 -> 1024 at 17x17)
    ("Mixed_6a/Branch_0/Conv2d_1a_3x3", (3, 3, 384, 384)),
    ("Mixed_6a/Branch_1/Conv2d_0a_1x1", (1, 1, 384, 192)),
    ("Mixed_6a/Branch_1/Conv2d_0b_3x3", (3, 3, 192, 224)),
    ("Mixed_6a/Branch_1/Conv2d_1a_3x3", (3, 3, 224, 256)),
]


def _block_b(scope: str) -> Table:
    # inception_v4.py:75-96 (input 17x17x1024, output 1024)
    return [(f"{scope}/Branch_0/Conv2d_0a_1x1", (1, 1, 1024, 384)),
            (f"{scope}/Branch_1/Conv2d_0a_1x1", (1, 1, 1024, 192)),
            (f"{scope}/Branch_1/Conv2d_0b_1x7", (1, 7, 192, 224)),
            (f"{scope}/Branch_1/Conv2d_0c_7x1", (7, 1, 224, 256)),
            (f"{scope}/Branch_2/Conv2d_0a_1x1", (1, 1, 1024, 192)),
            (f"{scope}/Branch_2/Conv2d_0b_7x1", (7, 1, 192, 192)),
            (f"{scope}/Branch_2/Conv2d_0c_1x7", (1, 7, 192, 224)),
            (f"{scope}/Branch_2/Conv2d_0d_7x1", (7, 1, 224, 224)),
            (f"{scope}/Branch_2/Conv2d_0e_1x7", (1, 7, 224, 256)),
            (f"{scope}/Branch_3/Conv2d_0b_1x1", (1, 1, 1024, 128))]


_REDUCTION_B: Table = [  # inception_v4.py:99-118 (1024 -> 1536 at 8x8)
    ("Mixed_7a/Branch_0/Conv2d_0a_1x1", (1, 1, 1024, 192)),
    ("Mixed_7a/Branch_0/Conv2d_1a_3x3", (3, 3, 192, 192)),
    ("Mixed_7a/Branch_1/Conv2d_0a_1x1", (1, 1, 1024, 256)),
    ("Mixed_7a/Branch_1/Conv2d_0b_1x7", (1, 7, 256, 256)),
    ("Mixed_7a/Branch_1/Conv2d_0c_7x1", (7, 1, 256, 320)),
    ("Mixed_7a/Branch_1/Conv2d_1a_3x3", (3, 3, 320, 320)),
]


def _block_c(scope: str) -> Table:
    # inception_v4.py:121-144 (input 8x8x1536, output 1536)
    return [(f"{scope}/Branch_0/Conv2d_0a_1x1", (1, 1, 1536, 256)),
            (f"{scope}/Branch_1/Conv2d_0a_1x1", (1, 1, 1536, 384)),
            (f"{scope}/Branch_1/Conv2d_0b_1x3", (1, 3, 384, 256)),
            (f"{scope}/Branch_1/Conv2d_0c_3x1", (3, 1, 384, 256)),
            (f"{scope}/Branch_2/Conv2d_0a_1x1", (1, 1, 1536, 384)),
            (f"{scope}/Branch_2/Conv2d_0b_3x1", (3, 1, 384, 448)),
            (f"{scope}/Branch_2/Conv2d_0c_1x3", (1, 3, 448, 512)),
            (f"{scope}/Branch_2/Conv2d_0d_1x3", (1, 3, 512, 256)),
            (f"{scope}/Branch_2/Conv2d_0e_3x1", (3, 1, 512, 256)),
            (f"{scope}/Branch_3/Conv2d_0b_1x1", (1, 1, 1536, 256))]


_AUX: Table = [  # inception_v4.py:286-300 (off Mixed_6h: 17x17x1024)
    ("AuxLogits/Conv2d_1b_1x1", (1, 1, 1024, 128)),
    ("AuxLogits/Conv2d_2a", (5, 5, 128, 768)),
]

# Ordered endpoint list (inception_v4.py:152-157)
ENDPOINTS: List[str] = (
    ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Mixed_3a",
     "Mixed_4a", "Mixed_5a"]
    + [f"Mixed_5{c}" for c in "bcde"] + ["Mixed_6a"]
    + [f"Mixed_6{c}" for c in "bcdefgh"] + ["Mixed_7a"]
    + [f"Mixed_7{c}" for c in "bcd"])
# the perceptual loss's endpoints (graph_single.py:473-489)
PERCEPTUAL_ENDPOINTS = ("Conv2d_2a_3x3", "Mixed_4a", "Mixed_5b")
# number of _STEM entries through each stem endpoint
_STEM_CUT = {"Conv2d_1a_3x3": 1, "Conv2d_2a_3x3": 2, "Conv2d_2b_3x3": 3,
             "Mixed_3a": 4, "Mixed_4a": 10, "Mixed_5a": 11}


def conv_table(final_endpoint: str = "Mixed_7d") -> Table:
    """All conv (path, shape) pairs of the base through ``final_endpoint``
    (JAX ``conv_table`` :122)."""
    if final_endpoint not in ENDPOINTS:
        raise ValueError(f"unknown endpoint {final_endpoint}")
    if final_endpoint in _STEM_CUT:
        return list(_STEM[:_STEM_CUT[final_endpoint]])
    table = list(_STEM)
    for name in ENDPOINTS[:ENDPOINTS.index(final_endpoint) + 1]:
        if name.startswith("Mixed_5") and name != "Mixed_5a":
            table.extend(_block_a(name))
        elif name == "Mixed_6a":
            table.extend(_REDUCTION_A)
        elif name.startswith("Mixed_6"):
            table.extend(_block_b(name))
        elif name == "Mixed_7a":
            table.extend(_REDUCTION_B)
        elif name.startswith("Mixed_7"):
            table.extend(_block_c(name))
    return table


class BatchNorm(nn.Module):
    """slim's batch norm at inference: moving statistics, ``beta``, no
    gamma (JAX ``_conv_bn_relu``, ``inception_v4.py:204-211``)."""

    def __init__(self, c: int):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(c))
        self.moving_mean = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.moving_variance = nn.Parameter(torch.ones(c),
                                            requires_grad=False)


class ConvBN(nn.Module):
    """A slim conv (no bias) + ``BatchNorm`` + ReLU; ``weights`` OIHW."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weights = nn.Parameter(
            truncated_normal((cout, cin, kh, kw), generator) * 0.1)
        self.BatchNorm = BatchNorm(cout)

    def forward(self, x: torch.Tensor, stride: int = 1,
                padding: str = "SAME") -> torch.Tensor:
        """x NCHW."""
        kh, kw = self.weights.shape[2:]
        if padding == "SAME":
            ph = same_pads(x.shape[2], kh, stride)
            pw = same_pads(x.shape[3], kw, stride)
            if ph[0] != ph[1] or pw[0] != pw[1]:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
                ph, pw = (0, 0), (0, 0)
            y = F.conv2d(x, self.weights, stride=stride,
                         padding=(ph[0], pw[0]))
        else:
            y = F.conv2d(x, self.weights, stride=stride)
        bn = self.BatchNorm
        y = ((y - bn.moving_mean[:, None, None])
             / torch.sqrt(bn.moving_variance + BN_EPS)[:, None, None]
             + bn.beta[:, None, None])
        return torch.relu(y)


class Dense(nn.Module):
    """A head: ``x @ weights + biases``, ``weights`` [fan_in, n]."""

    def __init__(self, fan_in: int, n: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weights = nn.Parameter(
            truncated_normal((fan_in, n), generator) * 0.05)
        self.biases = nn.Parameter(torch.zeros(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weights + self.biases


def _add_path(root: nn.Module, path: str, module: nn.Module) -> None:
    *scopes, leaf = path.split("/")
    node = root
    for name in scopes:
        if not hasattr(node, name):
            node.add_module(name, nn.Module())
        node = getattr(node, name)
    node.add_module(leaf, module)


class InceptionV4(nn.Module):
    """The base through ``final_endpoint``, fresh from ``generator`` (JAX
    ``init_params`` :170: kernels truncated normal x 0.1, heads x 0.05, BN
    beta 0, mean 0, variance 1).  With ``num_classes`` (and the full base)
    the Logits head and, with ``create_aux_logits``, the AuxLogits head
    are built too."""

    def __init__(self, final_endpoint: str = "Mixed_7d",
                 num_classes: Optional[int] = None,
                 create_aux_logits: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.final_endpoint = final_endpoint
        table = conv_table(final_endpoint)
        heads = []
        if num_classes is not None and final_endpoint == "Mixed_7d":
            if create_aux_logits:
                table.extend(_AUX)
                heads.append(("AuxLogits/Aux_logits", (768, num_classes)))
            heads.append(("Logits/Logits", (1536, num_classes)))
        for path, shape in table:
            _add_path(self, path, ConvBN(*shape, generator=generator))
        for path, shape in heads:
            _add_path(self, path, Dense(*shape, generator=generator))

    def forward(self, images: torch.Tensor, is_training: bool = False,
                dropout_generator: Optional[torch.Generator] = None,
                dropout_keep_prob: float = 0.8):
        """The full model; see ``inception_v4``."""
        return inception_v4(self, images, is_training, dropout_generator,
                            dropout_keep_prob)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)                      # 3x3/2 VALID


def _avg_pool(x):
    # slim.avg_pool2d 3x3/1 SAME: the count leaves the padding out
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _cat(outs):
    return torch.cat(outs, dim=1)


def _run_branches(x, scope: nn.Module, branches):
    """``branches``: for each ``Branch_i`` of ``scope`` the chain of
    (conv name, stride, padding) applied in order; the names "<maxpool>"
    and "<avgpool>" run the pool instead (JAX ``_run_branches``)."""
    outs = []
    for bi, chain in enumerate(branches):
        y = x
        for name, stride, padding in chain:
            if name == "<maxpool>":
                y = _max_pool(y)
            elif name == "<avgpool>":
                y = _avg_pool(y)
            else:
                y = getattr(getattr(scope, f"Branch_{bi}"), name)(
                    y, stride, padding)
        outs.append(y)
    return _cat(outs)


def _block_a_fwd(x, p):
    return _run_branches(x, p, [
        [("Conv2d_0a_1x1", 1, "SAME")],
        [("Conv2d_0a_1x1", 1, "SAME"), ("Conv2d_0b_3x3", 1, "SAME")],
        [("Conv2d_0a_1x1", 1, "SAME"), ("Conv2d_0b_3x3", 1, "SAME"),
         ("Conv2d_0c_3x3", 1, "SAME")],
        [("<avgpool>", 1, "SAME"), ("Conv2d_0b_1x1", 1, "SAME")]])


def _reduction_a_fwd(x, p):
    return _run_branches(x, p, [
        [("Conv2d_1a_3x3", 2, "VALID")],
        [("Conv2d_0a_1x1", 1, "SAME"), ("Conv2d_0b_3x3", 1, "SAME"),
         ("Conv2d_1a_3x3", 2, "VALID")],
        [("<maxpool>", 2, "VALID")]])


def _block_b_fwd(x, p):
    return _run_branches(x, p, [
        [("Conv2d_0a_1x1", 1, "SAME")],
        [("Conv2d_0a_1x1", 1, "SAME"), ("Conv2d_0b_1x7", 1, "SAME"),
         ("Conv2d_0c_7x1", 1, "SAME")],
        [("Conv2d_0a_1x1", 1, "SAME"), ("Conv2d_0b_7x1", 1, "SAME"),
         ("Conv2d_0c_1x7", 1, "SAME"), ("Conv2d_0d_7x1", 1, "SAME"),
         ("Conv2d_0e_1x7", 1, "SAME")],
        [("<avgpool>", 1, "SAME"), ("Conv2d_0b_1x1", 1, "SAME")]])


def _reduction_b_fwd(x, p):
    return _run_branches(x, p, [
        [("Conv2d_0a_1x1", 1, "SAME"), ("Conv2d_1a_3x3", 2, "VALID")],
        [("Conv2d_0a_1x1", 1, "SAME"), ("Conv2d_0b_1x7", 1, "SAME"),
         ("Conv2d_0c_7x1", 1, "SAME"), ("Conv2d_1a_3x3", 2, "VALID")],
        [("<maxpool>", 2, "VALID")]])


def _block_c_fwd(x, p):
    # Branch_1/Branch_2 fork into two parallel convs that are concatenated
    # (inception_v4.py:127-139)
    b1 = p.Branch_1.Conv2d_0a_1x1(x)
    b1 = _cat([p.Branch_1.Conv2d_0b_1x3(b1), p.Branch_1.Conv2d_0c_3x1(b1)])
    b2 = p.Branch_2.Conv2d_0a_1x1(x)
    b2 = p.Branch_2.Conv2d_0c_1x3(p.Branch_2.Conv2d_0b_3x1(b2))
    b2 = _cat([p.Branch_2.Conv2d_0d_1x3(b2), p.Branch_2.Conv2d_0e_3x1(b2)])
    return _cat([p.Branch_0.Conv2d_0a_1x1(x), b1, b2,
                 p.Branch_3.Conv2d_0b_1x1(_avg_pool(x))])


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def inception_v4_base(model: InceptionV4, images: torch.Tensor,
                      final_endpoint: str = "Mixed_7d"
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The v4 base through ``final_endpoint`` (JAX
    ``inception_v4_base`` :302; ``inception_v4.py:147-253``).  images
    [N, 299, 299, 3].  Returns (net, endpoints), NHWC."""
    end_points: Dict[str, torch.Tensor] = {}
    stop = ENDPOINTS.index(final_endpoint)        # validates the name
    m = model

    def done(name, net):
        end_points[name] = _nhwc(net)
        return ENDPOINTS.index(name) >= stop

    def result():
        return end_points[final_endpoint], end_points

    x = m.Conv2d_1a_3x3(images.permute(0, 3, 1, 2), 2, "VALID")
    if done("Conv2d_1a_3x3", x):
        return result()
    x = m.Conv2d_2a_3x3(x, 1, "VALID")
    if done("Conv2d_2a_3x3", x):
        return result()
    x = m.Conv2d_2b_3x3(x, 1, "SAME")
    if done("Conv2d_2b_3x3", x):
        return result()

    x = _cat([_max_pool(x),
              m.Mixed_3a.Branch_1.Conv2d_0a_3x3(x, 2, "VALID")])
    if done("Mixed_3a", x):
        return result()

    m4 = m.Mixed_4a
    b0 = m4.Branch_0.Conv2d_1a_3x3(m4.Branch_0.Conv2d_0a_1x1(x), 1, "VALID")
    b1 = m4.Branch_1.Conv2d_0a_1x1(x)
    b1 = m4.Branch_1.Conv2d_0c_7x1(m4.Branch_1.Conv2d_0b_1x7(b1))
    b1 = m4.Branch_1.Conv2d_1a_3x3(b1, 1, "VALID")
    x = _cat([b0, b1])
    if done("Mixed_4a", x):
        return result()

    x = _cat([m.Mixed_5a.Branch_0.Conv2d_1a_3x3(x, 2, "VALID"),
              _max_pool(x)])
    if done("Mixed_5a", x):
        return result()

    for c in "bcde":
        x = _block_a_fwd(x, getattr(m, f"Mixed_5{c}"))
        if done(f"Mixed_5{c}", x):
            return result()
    x = _reduction_a_fwd(x, m.Mixed_6a)
    if done("Mixed_6a", x):
        return result()
    for c in "bcdefgh":
        x = _block_b_fwd(x, getattr(m, f"Mixed_6{c}"))
        if done(f"Mixed_6{c}", x):
            return result()
    x = _reduction_b_fwd(x, m.Mixed_7a)
    if done("Mixed_7a", x):
        return result()
    for c in "bcd":
        x = _block_c_fwd(x, getattr(m, f"Mixed_7{c}"))
        if done(f"Mixed_7{c}", x):
            return result()
    raise AssertionError("unreachable: the last endpoint always stops")


def inception_v4(model: InceptionV4, images: torch.Tensor,
                 is_training: bool = False,
                 dropout_generator: Optional[torch.Generator] = None,
                 dropout_keep_prob: float = 0.8
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full model with its heads (JAX ``inception_v4`` :368;
    ``inception_v4.py:255-318``).  Returns (logits, end_points) with
    'AuxLogits' (when the model has that head), 'PreLogitsFlatten',
    'Logits' and 'Predictions'.  At train time the pre-logits drop with
    keep ``dropout_keep_prob``, drawn from ``dropout_generator`` (on the
    model's device; the default generator when None)."""
    net, end_points = inception_v4_base(model, images, "Mixed_7d")

    if hasattr(model, "AuxLogits"):
        aux = F.avg_pool2d(end_points["Mixed_6h"].permute(0, 3, 1, 2), 5, 3)
        aux = model.AuxLogits.Conv2d_1b_1x1(aux)
        aux = model.AuxLogits.Conv2d_2a(aux, 1, "VALID")
        end_points["AuxLogits"] = model.AuxLogits.Aux_logits(
            _nhwc(aux).reshape(aux.shape[0], -1))

    # global average pool over the full 8x8 extent, dropout, fc
    net = net.mean(dim=(1, 2))
    if is_training and dropout_keep_prob < 1.0:
        keep = torch.rand(net.shape, generator=dropout_generator,
                          device=net.device) < dropout_keep_prob
        net = torch.where(keep, net / dropout_keep_prob,
                          torch.zeros_like(net))
    end_points["PreLogitsFlatten"] = net
    logits = model.Logits.Logits(net)
    end_points["Logits"] = logits
    end_points["Predictions"] = torch.softmax(logits, dim=-1)
    return logits, end_points


def extract_endpoints(model: InceptionV4, images: torch.Tensor
                      ) -> List[torch.Tensor]:
    """images [N, 299, 299, 3] in [0, 1] -> the three perceptual endpoints
    [Conv2d_2a_3x3, Mixed_4a, Mixed_5b] (JAX ``extract_endpoints`` :407)."""
    _, eps = inception_v4_base(model, images, "Mixed_5b")
    return [eps[name] for name in PERCEPTUAL_ENDPOINTS]


def perceptual_loss(model: InceptionV4, image1: torch.Tensor,
                    image2: torch.Tensor) -> torch.Tensor:
    """Mean-L1 over the three endpoints (JAX ``perceptual_loss`` :415;
    ``graph_single.get_perceptual_loss``).  Inputs in [-1, 1] NHWC at any
    size, mapped to [0, 1] and resized to 299 like the reference.  Under a
    data-parallel mesh, a shard's share of the global batch's loss
    (``parallel.mesh.shard_mean``)."""
    def prep(img):
        return resize_bilinear_half_pixel((img + 1.0) / 2.0, 299, 299)
    e1 = extract_endpoints(model, prep(image1))
    e2 = extract_endpoints(model, prep(image2))
    return sum(shard_mean(torch.abs(a - b)) for a, b in zip(e1, e2))

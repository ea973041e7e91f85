"""A run loads neither JAX nor the JAX package: a tiny serving run and a
tiny training run in a fresh process, then the harness's own look at
``sys.modules`` (top-level names compared whole: the port's name begins
with the JAX package's)."""
import os
import subprocess
import sys

from benchmark.harness import ROOT, forbidden_modules

SCRIPT = r"""
import sys, time
sys.path.insert(0, {root!r})
from benchmark.drivers import serve_session, train_matching
from benchmark.harness import forbidden_modules
from benchmark.tests.tiny import tiny_serve_config, tiny_traffic, tiny_train_config
run = serve_session.run(cell={{"name": "fg_interactive"}}, config=tiny_serve_config(),
                        traffic=tiny_traffic("fg_interactive"), seed=3, seconds=1.0,
                        trace=False, started=time.time(), device="cpu")
assert run.correct, run.checks
tf = tiny_traffic("matching_train", pool_batches=4)
run = train_matching.run(cell={{"name": "matching_train"}}, config=tiny_train_config(),
                         traffic=tf, seed=3, seconds=1.0, trace=False,
                         started=time.time(), device="cpu")
assert run.correct, run.checks
print("FORBIDDEN", forbidden_modules())
import sketchyscenecolorization_torch
print("PORT", "sketchyscenecolorization_torch" in sys.modules)
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "PORT True" in out.stdout


def test_the_look_compares_whole_top_level_names(monkeypatch):
    for name in [n for n in sys.modules
                 if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                        "sketchyscenecolorization_tpu")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "jaxlike_module", sys)
    monkeypatch.setitem(sys.modules, "sketchyscenecolorization_tpu_x", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sketchyscenecolorization_tpu.ops", sys)
    assert forbidden_modules() == ["sketchyscenecolorization_tpu"]

"""Port of the weights and the package boundary: JAX params carried into
``repro_torch`` bit for bit, the port importing neither JAX nor the JAX
package, and its entry points refusing to fall back to the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.models.pdef import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.core import MLCEngine
from repro_torch.models import params as tparams
from repro_torch.weights import from_jax_params, to_tensor

# the suite runs these files beside CPU-timed benchmarks in parallel
# workers: one intra-op thread keeps torch from oversubscribing cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("llama-3.1-8b", reduced=True)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.uint8)


def _np_bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.uint8)


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jax_get_config("llama-3.1-8b", reduced=True)
    p = jax_init_params(jax_model.params_def(cfg), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def test_from_jax_params_bitwise(jax_tree):
    """Every leaf, per layer, equals the JAX leaf (unstacked from the
    scanned blocks) bit for bit, with the same dtype and shape."""
    port = from_jax_params(CFG, jax_tree)
    assert port["embed"].dtype == torch.bfloat16
    assert port["final_norm"].dtype == torch.float32
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(_bits(port[name]),
                                      _np_bits(jax_tree[name]))
    g = CFG.grouped_pattern()
    assert g.n_blocks == CFG.n_layers and not g.prefix and not g.suffix
    blocks = jax_tree["decoder"]["blocks"][0]
    assert len(port["layers"]) == CFG.n_layers
    n = 0
    for li, layer in enumerate(port["layers"]):
        for path in (("mixer_norm",), ("ffn_norm",), ("attn", "wq"),
                     ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                     ("ffn", "wi"), ("ffn", "wg"), ("ffn", "wo")):
            got, want = layer, blocks
            for k in path:
                got, want = got[k], want[k]
            want = want[li]
            assert tuple(got.shape) == want.shape, path
            np.testing.assert_array_equal(_bits(got), _np_bits(want))
            n += 1
    assert n == 9 * CFG.n_layers
    # the port's param defs describe exactly these leaves
    defs = tparams.params_def(CFG)
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(defs[name].shape) == tuple(port[name].shape)
        assert defs[name].dtype == port[name].dtype


def test_to_tensor_keeps_bf16_bits():
    a = np.asarray(jax.numpy.asarray([1.0, -2.5, 3e-3, 65504.0],
                                     jax.numpy.bfloat16))
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  a.astype(np.float32))


@pytest.mark.parametrize("reduced", [True, False])
def test_param_count_matches_reference(reduced):
    ref = jax_get_config("llama-3.1-8b", reduced=reduced).num_params()
    assert get_config("llama-3.1-8b", reduced=reduced).num_params() == ref


def test_init_params_seeded_and_shaped():
    a = tparams.init_params(CFG, 3, "cpu")
    b = tparams.init_params(CFG, 3, "cpu")
    for x, y in zip(tparams.tree_leaves(a), tparams.tree_leaves(b)):
        assert torch.equal(x, y)
    # normal x 0.02, zeros, ones: the reference's rules
    assert abs(float(a["embed"].float().std()) - 0.02) < 2e-3
    assert torch.all(a["final_norm"] == 1.0)


def test_port_imports_neither_jax_nor_repro():
    """A fresh interpreter imports every ``repro_torch`` module and the
    smoke script: neither ``jax`` nor any ``repro`` module may load."""
    code = r"""
import importlib, pkgutil, sys
sys.argv = ["chip_smoke.py"]
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401

bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "repro"
             or m.startswith("repro."))
print(len(mods), "modules")
assert not bad, bad
assert "repro_torch.core.engine" in sys.modules
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20


def test_load_model_without_device_raises_on_cpu_only_box():
    """``device=None`` means CUDA: with no card it raises instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None uses it")
    eng = MLCEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.load_model("m", CFG, backend="paged", max_slots=2,
                       max_context=64)
    assert "m" not in eng.models


@pytest.mark.parametrize("kw,item", [
    (dict(backend="dense"), "A4"),
    (dict(quantize=True), "A4"),
])
def test_unported_options_name_their_roadmap_item(kw, item):
    kw = dict(dict(backend="paged"), **kw)
    with pytest.raises(NotImplementedError, match=item):
        MLCEngine().load_model("m", CFG, max_slots=2, max_context=64,
                               device="cpu", **kw)

"""The port's ``MLCEngine`` against the JAX package's engine, same
weights: the README's port quickstart runs on the CPU, and a seeded
mixed workload (greedy, stochastic, penalties, ``n=2`` forks, stop
strings, chunked prefill) emits byte-identical choices at pipeline
depths 1 and 2, with speculation off and with ``prompt_lookup``."""
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import ChatCompletionRequest as JaxRequest
from repro.core import ChatMessage as JaxMessage
from repro.core import MLCEngine as JaxEngine
from repro.models import model as jax_model
from repro.models.pdef import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.core import ChatCompletionRequest, ChatMessage, MLCEngine
from repro_torch.weights import from_jax_params

# the suite runs these files beside CPU-timed benchmarks in parallel
# workers: one intra-op thread keeps torch from oversubscribing cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("llama-3.1-8b", reduced=True)
JCFG = jax_get_config("llama-3.1-8b", reduced=True)
# a differing token is a true tie only when the reference's top-2 logit
# margin there is inside the logits tolerance of the two paths (bf16
# logits from two BLAS libraries: tests/test_torch_paged_runner.py)
LOGIT_ATOL = 3e-2


def test_readme_port_quickstart_executes():
    """The README's port quickstart (the python block that imports
    ``repro_torch``) runs verbatim on the CPU."""
    readme = (ROOT / "README.md").read_text()
    blocks = [b for b in re.findall(r"```python\n(.*?)```", readme,
                                    re.DOTALL) if "repro_torch" in b]
    assert blocks, "README.md has no repro_torch quickstart block"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", blocks[0]], cwd=ROOT,
                         env=env, timeout=300, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "prefix-cached prompt tokens:" in out.stdout, out.stdout


LONG = "The quick brown fox jumps over the lazy dog. " * 4
REP = "one two three four one two three four one two three four"
MIXED = [
    dict(text=REP, max_tokens=12, temperature=0.0, seed=0),
    dict(text=LONG, max_tokens=10, temperature=0.8, seed=5),
    dict(text="tell me a story", max_tokens=10, temperature=1.2, seed=9,
         frequency_penalty=0.7, presence_penalty=0.3),
    dict(text="two ways", max_tokens=6, temperature=0.9, seed=3, n=2,
         stop=["XYZZY"]),
    dict(text="hello world", max_tokens=8, temperature=0.0, top_k=4,
         seed=1),
]
ENGINE_KW = dict(max_slots=3, max_context=96, page_size=4,
                 prefill_chunk_size=6, seed=0, enable_prefix_cache=False,
                 draft_k=3)


@pytest.fixture(scope="module")
def weights():
    p = jax_init_params(jax_model.params_def(JCFG), jax.random.PRNGKey(0))
    return p, from_jax_params(CFG, jax.tree.map(np.asarray, p))


def _run_all(eng, reqs):
    out = [None] * len(reqs)

    def go(i):
        out[i] = eng.chat_completions_create(reqs[i])

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
        time.sleep(0.05)
    for t in ts:
        t.join(timeout=300)
    assert all(r is not None for r in out)
    return out


def _requests(req_cls, msg_cls):
    reqs = []
    for spec in MIXED:
        kw = {k: v for k, v in spec.items() if k != "text"}
        reqs.append(req_cls(model="m", messages=[msg_cls("user",
                                                         spec["text"])],
                            logprobs=True, top_logprobs=2, **kw))
    return reqs


def _choices(resp):
    return [(c.message.content, c.finish_reason,
             [(e.token, e.logprob, [t.logprob for t in e.top_logprobs])
              for e in c.logprobs.content])
            for c in resp.choices]


def _drained(eng, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if eng.stats("m")["scheduler"]["running"] == 0:
            return True
        time.sleep(0.02)
    return False


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX engine's choices (depth 1, speculation off — the
    reference suite already holds the other three settings to it)."""
    eng = JaxEngine()
    eng.load_model("m", JCFG, params=weights[0], backend="paged",
                   pipeline_depth=1, speculation="off", **ENGINE_KW)
    try:
        return [_choices(r) for r in _run_all(
            eng, _requests(JaxRequest, JaxMessage))]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("spec", ["off", "prompt_lookup"])
@pytest.mark.parametrize("depth", [1, 2])
def test_engine_matches_jax_engine(weights, reference, spec, depth):
    eng = MLCEngine()
    eng.load_model("m", CFG, params=weights[1], backend="paged",
                   pipeline_depth=depth, speculation=spec, device="cpu",
                   **ENGINE_KW)
    try:
        got = [_choices(r) for r in _run_all(
            eng, _requests(ChatCompletionRequest, ChatMessage))]
        assert _drained(eng)
        st = eng.stats("m")
    finally:
        eng.shutdown(wait=True)
    for r_ref, r_got in zip(reference, got):
        for (text_ref, fin_ref, lp_ref), (text, fin, lp) in zip(r_ref,
                                                                r_got):
            if (text, fin) == (text_ref, fin_ref):
                assert [e[0] for e in lp] == [e[0] for e in lp_ref]
                for a, b in zip(lp, lp_ref):
                    assert abs(a[1] - b[1]) < LOGIT_ATOL
                continue
            # a divergence passes only as a true tie at its first token
            i = next(k for k, (a, b) in enumerate(zip(lp, lp_ref))
                     if a[0] != b[0])
            margin = lp_ref[i][2][0] - lp_ref[i][2][1]
            assert margin < LOGIT_ATOL, (i, text, text_ref, margin)
    e = st["engine"]
    assert st["runner"]["attn_kernel_calls"] == e["exec_steps"]
    assert st["runner"]["host_logit_rows"] == 0
    assert st["runner"]["pages"]["used_pages"] == 0
    if spec == "prompt_lookup":
        assert e["drafted"] > 0 and e["accepted"] > 0
    else:
        assert e["drafted"] == 0

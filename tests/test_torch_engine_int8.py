"""The port's engine on int8 KV pages (``kv_dtype="int8"``) against the
JAX package's int8 engine, same weights: a seeded mixed workload
(greedy, stochastic, penalties, ``n=2`` forks, chunked prefill) emits the
same choices, token for token, at pipeline depths 1 and 2 with
speculation off and with ``prompt_lookup``; the fused path keeps one
attention launch per step and no logit rows on the host."""
import threading
import time

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

CFG = get_config("llama-3.1-8b", reduced=True)
JCFG = jax_get_config("llama-3.1-8b", reduced=True)
# a differing token is a true tie only when the reference's top-2 logit
# margin there is inside the logits tolerance of the two paths (bf16
# logits from two BLAS libraries: tests/test_torch_paged_runner.py)
LOGIT_ATOL = 3e-2
REP = "one two three four one two three four one two three four"
MIXED = [
    dict(text=REP, max_tokens=12, temperature=0.0, seed=0),
    dict(text="The quick brown fox jumps over the lazy dog. " * 3,
         max_tokens=10, temperature=0.8, seed=5),
    dict(text="tell me a story", max_tokens=10, temperature=1.2, seed=9,
         frequency_penalty=0.7, presence_penalty=0.3),
    dict(text="two ways", max_tokens=6, temperature=0.9, seed=3, n=2),
]
ENGINE_KW = dict(max_slots=3, max_context=96, page_size=4,
                 prefill_chunk_size=6, seed=0, enable_prefix_cache=False,
                 draft_k=3, kv_dtype="int8")


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
    return [[(c.message.content,
              [(e.token, [t.logprob for t in e.top_logprobs])
               for e in c.logprobs.content]) for c in r.choices]
            for r in out]


def _requests(req_cls, msg_cls):
    return [req_cls(model="m", messages=[msg_cls("user", s["text"])],
                    logprobs=True, top_logprobs=2,
                    **{k: v for k, v in s.items() if k != "text"})
            for s in MIXED]


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX int8 engine's choices (depth 1, speculation off)."""
    eng = JaxEngine()
    eng.load_model("m", JCFG, params=weights[0], backend="paged",
                   pipeline_depth=1, speculation="off", **ENGINE_KW)
    try:
        return _run_all(eng, _requests(JaxRequest, JaxMessage))
    finally:
        eng.shutdown()


@pytest.mark.parametrize("spec", ["off", "prompt_lookup"])
@pytest.mark.parametrize("depth", [1, 2])
def test_int8_engine_matches_jax_int8_engine(weights, reference, spec,
                                             depth):
    eng = MLCEngine()
    eng.load_model("m", CFG, params=weights[1], backend="paged",
                   pipeline_depth=depth, speculation=spec, device="cpu",
                   **ENGINE_KW)
    try:
        got = _run_all(eng, _requests(ChatCompletionRequest, ChatMessage))
        st = eng.stats("m")
    finally:
        eng.shutdown(wait=True)
    for r_ref, r_got in zip(reference, got):
        for (text_ref, lp_ref), (text, lp) in zip(r_ref, r_got):
            if text == text_ref:
                continue
            # a divergence passes only as a true tie at its first token
            i = next(k for k, (a, b) in enumerate(zip(lp, lp_ref))
                     if a[0] != b[0])
            margin = lp_ref[i][1][0] - lp_ref[i][1][1]
            assert margin < LOGIT_ATOL, (i, text, text_ref, margin)
    assert st["runner"]["kv_dtype"] == "int8"
    assert st["runner"]["attn_kernel_calls"] == st["engine"]["exec_steps"]
    assert st["runner"]["host_logit_rows"] == 0
    if spec == "prompt_lookup":
        assert st["engine"]["drafted"] > 0

"""The port's engine serving q4 weights on int8 KV pages
(``weight_quant="w4a16", kv_dtype="int8"``, WebLLM's default quantized
serving) against the JAX package's engine with the same options and
weights: greedy traffic emits the same tokens, one for one, at pipeline
depths 1 and 2, and every projection went through the W4A16 product."""
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
GREEDY = [
    dict(text="one two three four one two three four", max_tokens=12),
    dict(text="The quick brown fox jumps over the lazy dog. " * 3,
         max_tokens=10),
    dict(text="hello world", max_tokens=8),
]
ENGINE_KW = dict(max_slots=3, max_context=96, page_size=4,
                 prefill_chunk_size=6, seed=0, enable_prefix_cache=False,
                 kv_dtype="int8", weight_quant="w4a16")


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
                    logprobs=True, top_logprobs=2, temperature=0.0,
                    max_tokens=s["max_tokens"]) for s in GREEDY]


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX engine's choices (W4A16 + int8 KV, depth 1)."""
    eng = JaxEngine()
    eng.load_model("m", JCFG, params=weights[0], backend="paged",
                   pipeline_depth=1, speculation="off", **ENGINE_KW)
    try:
        return _run_all(eng, _requests(JaxRequest, JaxMessage))
    finally:
        eng.shutdown()


@pytest.mark.parametrize("depth", [1, 2])
def test_w4a16_int8_engine_matches_jax_engine(weights, reference, depth):
    from repro_torch.quant.int4 import is_qtensor
    eng = MLCEngine()
    eng.load_model("m", CFG, params=weights[1], backend="paged",
                   pipeline_depth=depth, device="cpu", **ENGINE_KW)
    layer = eng.models["m"].runner.runner.layers[0]
    assert is_qtensor(layer["attn"]["wo"]) and is_qtensor(layer["ffn"]["wi"])
    assert not is_qtensor(eng.models["m"].runner.runner.params["embed"])
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
    assert st["runner"]["weight_quant"] == "w4a16"
    assert st["runner"]["attn_kernel_calls"] == st["engine"]["exec_steps"]
    assert st["runner"]["host_logit_rows"] == 0

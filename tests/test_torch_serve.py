"""The port's QAEngine end to end on tiny-git, against the JAX package's
QAEngine on the same weights, requests and tokenizer (both in f32)."""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sasvqa_tpu.core.config import ConfigDict
from sasvqa_tpu.models.presets import build_model as jax_build_model
from sasvqa_tpu.tasks import serve as jserve
from sasvqa_tpu.tasks.run_video_qa import build_tokenizer as jax_tokenizer

from sasvqa_torch.models.presets import build_model
from sasvqa_torch.tasks import serve as tserve
from sasvqa_torch.tasks.run_video_qa import build_tokenizer

from _torch_parity import TINY_GIT, frames, load_flax_params

K_STORED, IMG, NFRAME = 6, 32, 2
ANS = {"dog": 0, "cat": 1, "red": 2}
ENGINE_KW = dict(nframe=NFRAME, samp_policy="uniform", batch_size=4,
                 linger_ms=30.0, max_txt_len=8, max_text_len=12)


@pytest.fixture(scope="module")
def models():
    family, jm = jax_build_model(ConfigDict(TINY_GIT), dtype=jnp.float32)
    ids = jnp.ones((1, 4), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(0), ids, jnp.ones_like(ids),
                              jnp.zeros((1, 1, IMG, IMG, 3)))
    _, tm = build_model(TINY_GIT, device="cpu")
    load_flax_params(tm, params)
    return family, jm, params, tm


@pytest.fixture(scope="module")
def engine(models):
    family, _, _, tm = models
    eng = tserve.QAEngine(tm, family, build_tokenizer(TINY_GIT, family),
                          ans2label=ANS, device="cpu", **ENGINE_KW)
    yield eng
    eng.close()


def _requests(n, seed=0):
    questions = ["what is the dog doing", "who is in the video",
                 "what color is the ball", "where is the cat running",
                 "how"]
    return [(frames(seed + i, K_STORED, IMG), questions[i % len(questions)])
            for i in range(n)]


def test_answers_match_jax_engine(models, engine):
    family, jm, params, _ = models
    reqs = _requests(6)
    with jserve.QAEngine(jm, params, family,
                         jax_tokenizer(ConfigDict(TINY_GIT), family),
                         ans2label=ANS, **ENGINE_KW) as jeng:
        ref = [jeng.answer(f, q, timeout=300) for f, q in reqs]
    futs = [engine.submit(f, q) for f, q in reqs]
    ours = [f.result(timeout=300) for f in futs]
    assert ours == ref
    assert all(isinstance(o["answer"], str) for o in ours)


def test_concurrent_submits_match_direct_batch(engine):
    reqs = _requests(4, seed=10)
    expected = engine._run_batch([(f, q, None) for f, q in reqs])
    results = {}

    def worker(i):
        f, q = reqs[i]
        results[i] = engine.answer(f, q, timeout=300)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert [results[i] for i in range(4)] == expected


def test_partial_batch_equals_full_batch(engine):
    f, q = _requests(1, seed=7)[0]
    solo = engine.submit(f, q).result(timeout=300)
    full = engine._run_batch([(f, q, None)] * 4)
    assert solo == full[0]


def test_mismatched_shape_rejected_at_submit(engine):
    engine.answer(*_requests(1)[0], timeout=300)
    with pytest.raises(ValueError, match="pinned shape"):
        engine.submit(np.zeros((K_STORED + 2, IMG, IMG, 3), np.float32), "q")
    with pytest.raises(ValueError, match="pinned shape"):
        engine.submit(np.zeros((K_STORED, IMG * 2, IMG * 2, 3), np.float32),
                      "q")
    with pytest.raises(ValueError):
        engine.submit(np.zeros((IMG, IMG, 3), np.float32), "q")
    assert "answer" in engine.answer(*_requests(1, seed=3)[0], timeout=300)


def test_close_drains_then_refuses_and_fails_stragglers(models):
    """Queued requests are answered before close returns; afterwards
    submit raises, and a request that got behind the shutdown sentinel
    has its future failed instead of left hanging."""
    from concurrent.futures import Future
    family, _, _, tm = models
    eng = tserve.QAEngine(tm, family, build_tokenizer(TINY_GIT, family),
                          device="cpu", **dict(ENGINE_KW, batch_size=1,
                                               linger_ms=1.0))
    gate, entered = threading.Event(), threading.Event()
    real_run = eng._run_batch

    def slow_run(reqs):
        entered.set()
        assert gate.wait(timeout=300)
        return real_run(reqs)

    eng._run_batch = slow_run
    blocker = eng.submit(*_requests(1)[0])
    assert entered.wait(timeout=300)
    straggler = Future()
    with eng._lock:
        eng._closed = True
        eng._queue.put(None)
        eng._queue.put((frames(1, K_STORED, IMG), "too late", straggler))
    gate.set()
    eng._thread.join(timeout=300)
    assert not eng._thread.is_alive()
    assert "answer" in blocker.result(timeout=5)
    with pytest.raises(RuntimeError, match="closed"):
        straggler.result(timeout=5)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(*_requests(1)[0])


def test_only_git_family_served(models):
    """The engine takes the three families and refuses any other name; a
    classifier family (CLIP, BLIP) needs its answer vocabulary."""
    _, _, _, tm = models
    with pytest.raises(ValueError, match="unknown model family"):
        tserve.QAEngine(tm, "vit", None, device="cpu")
    for family in ("clip", "blip"):
        with pytest.raises(ValueError, match="ans2label"):
            tserve.QAEngine(tm, family, None, device="cpu")


def test_serve_requests_keeps_order_and_propagates_decode_errors():
    import io
    import json
    import time
    from concurrent.futures import Future

    class _FakeEngine:
        def submit(self, frames, question):
            fut = Future()

            def resolve():
                time.sleep(0.002)
                fut.set_result({"answer": question[::-1], "label": 0})

            threading.Thread(target=resolve, daemon=True).start()
            return fut

    reqs = [{"video": f"v{i}", "question": f"q{i}"} for i in range(40)]
    out = io.StringIO()
    tserve.serve_requests(_FakeEngine(), reqs, lambda req: None, out,
                          batch_size=4, decode_workers=2)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [ln["question"] for ln in lines] == [r["question"] for r in reqs]
    assert all(ln["answer"] == ln["question"][::-1] for ln in lines)

    def boom(req):
        raise OSError(f"decode failed: {req['video']}")

    with pytest.raises(OSError, match="decode failed"):
        tserve.serve_requests(_FakeEngine(), reqs[:3], boom, io.StringIO(),
                              batch_size=4, decode_workers=2)

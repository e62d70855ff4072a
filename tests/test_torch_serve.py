"""The port's serving engine (``repro_torch.serve``) on the host.

Two kinds of test:

* the reference's own engine tests (``tests/test_serve.py``) on the
  port's engine, against the port's forward: prefill and decode against
  the full forward, the scheduler's invariants after every tick of a
  seeded trace (``cache.check()``: every page free xor owned by exactly
  one slot), faults and edge cases.  They assert on the integer tick
  clock and the allocator's bookkeeping only, never on wall time;
* the port against the reference on the same parameters
  (``from_jax_numpy``) and the same seeded trace: at O0 the two engines
  give identical tokens, tick stamps, finish reasons, page tables and
  free-lists after every tick, and pools within O0's logits tolerance
  (1e-4: fp32 sums in another order) and one bf16 rounding (rtol 2^-7:
  the K/V are stored in bf16); the workload generators, the metrics and
  the record schema agree.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RRunConfig
from repro.configs.registry import get_smoke as r_get_smoke
from repro.models import build as r_build
from repro.models.params import init as r_init
from repro.serve import engine as r_engine
from repro.serve import metrics as r_metrics
from repro.serve import workload as r_workload
from repro.trace import compare as r_compare
from repro.trace import store as r_store
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_smoke
from repro_torch.models.api import build
from repro_torch.models.params import from_jax_numpy, init
from repro_torch.resilience import faults
from repro_torch.serve import metrics, trace
from repro_torch.serve.engine import SERVABLE_FAMILIES, Engine, Request
from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.serve.workload import bursty_trace, make_trace, poisson_trace
from repro_torch.session.session import Session

RUN = RunConfig(amp="O1")
ARCH = "minitron-4b"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def engine(cfg, params, **kw):
    return Engine(cfg, kw.pop("run", RUN), params, device="cpu", **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke(ARCH)
    model = build(cfg)
    params = init(model.spec, torch.Generator().manual_seed(0))
    return cfg, model, params


def greedy(model, params, cfg, tokens, n, run=RUN) -> list[int]:
    """``n`` greedy tokens by repeated full forwards."""
    seq = list(tokens)
    with torch.no_grad():
        for _ in range(n):
            lg = model.forward_fn(params, {"tokens": torch.tensor(
                seq, dtype=torch.int32)[None]}, run)
            seq.append(int(torch.argmax(lg[0, -1, :cfg.vocab_size])))
    return seq[len(tokens):]


def tick_with_invariants(eng: Engine) -> None:
    """One engine tick followed by the allocator + scheduler invariants
    every simulation in this file re-checks."""
    eng.tick()
    eng.cache.check()                       # no page leaked / owned twice
    for i, slot in enumerate(eng._slots):
        if slot is None:
            assert not eng.cache.slot_pages(i), \
                f"empty slot {i} still owns pages"
        else:
            have = len(eng.cache.slot_pages(i))
            need = eng.cache.pages_for(int(eng.cache.lengths[i]))
            assert have >= need, f"slot {i}: {have} pages < {need} needed"
            assert len(slot.req.out) <= slot.req.max_new


def drive(eng: Engine, reqs: list, max_ticks: int = 300) -> int:
    """Deterministic tick-by-tick trace runner (the run_trace loop, with
    invariants checked after every tick); returns ticks consumed."""
    pending = sorted(reqs, key=lambda r: r.arrival)
    i = 0
    for t in range(max_ticks):
        while i < len(pending) and pending[i].arrival <= eng.tick_count:
            eng.submit(pending[i])
            i += 1
        if i == len(pending) and not eng.queue and eng.n_active == 0:
            return t
        tick_with_invariants(eng)
    raise AssertionError(f"engine wedged: {max_ticks} ticks, "
                         f"{eng.n_active} active, {len(eng.queue)} queued")


# --------------------------------------------------------------------------
# the reference's engine tests, on the port
# --------------------------------------------------------------------------

class TestEngine:
    def test_prefill_matches_forward(self, setup):
        cfg, model, params = setup
        prompt = np.array([5, 7, 9, 11], np.int32)
        eng = engine(cfg, params, n_slots=1, max_len=16)
        r = Request(0, prompt, max_new=1)
        eng.serve([r])
        assert r.out == greedy(model, params, cfg, prompt, 1)

    def test_decode_matches_forward_continuation(self, setup):
        """Engine greedy decode ≡ repeated full-forward greedy decode."""
        cfg, model, params = setup
        prompt = np.array([3, 1, 4], np.int32)
        eng = engine(cfg, params, n_slots=1, max_len=16)
        r = Request(0, prompt, max_new=4)
        eng.serve([r])
        assert r.out == greedy(model, params, cfg, prompt, 4)

    def test_chunked_prefill_matches_forward_continuation(self, setup):
        """Multi-chunk prefill (prefill_first + prefill_ext across page
        boundaries) matches the full-forward greedy reference."""
        cfg, model, params = setup
        prompt = np.arange(11, dtype=np.int32) % cfg.vocab_size
        eng = engine(cfg, params, n_slots=1, max_len=16, prefill_chunk=4,
                     page_size=4)
        r = Request(0, prompt, max_new=3)
        eng.serve([r])
        assert eng.calls["prefill_first"] == 1
        assert eng.calls["prefill_ext"] == 2           # 11 tokens / chunk 4
        assert r.out == greedy(model, params, cfg, prompt, 3)

    def test_per_call_walls_and_kept_logits(self, setup):
        """Each call's wall is kept, in call order (the sums and counts
        are theirs); while asked, each call's logits are too, and their
        greedy tokens are the served ones."""
        cfg, model, params = setup
        prompt = np.arange(11, dtype=np.int32) % cfg.vocab_size
        eng = engine(cfg, params, n_slots=2, max_len=16, prefill_chunk=4,
                     page_size=4)
        eng.serve([Request(0, prompt, max_new=2)])
        assert not eng.logits
        assert eng.calls == {"prefill_first": 1, "prefill_ext": 2,
                             "decode": 1}
        for name, walls in eng.call_walls.items():
            assert all(w > 0 for w in walls)
            assert eng.wall[name] == sum(walls)
        eng.keep_logits = True
        r = Request(1, prompt, max_new=3)
        eng.serve([r])
        names = [name for name, _ in eng.logits]
        assert names == ["prefill_first"] + ["prefill_ext"] * 2 \
            + ["decode"] * 2
        first = eng.logits[2][1][:cfg.vocab_size]
        assert first.dtype == torch.float32
        assert eng.logits[-1][1].shape[0] == 2          # one row a slot
        toks = [int(torch.argmax(first))] + [
            int(torch.argmax(lg[0, :cfg.vocab_size]))
            for _, lg in eng.logits[3:]]
        assert toks == r.out

    def test_continuous_batching_completes_more_requests_than_slots(
            self, setup):
        cfg, _, params = setup
        eng = engine(cfg, params, n_slots=2, max_len=32)
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, 4).astype(
            np.int32), max_new=3) for i in range(5)]
        eng.serve(reqs)
        assert all(r.done for r in reqs)
        assert all(len(r.out) == 3 for r in reqs)

    def test_eos_stops_early(self, setup):
        cfg, model, params = setup
        prompt = np.array([2, 4], np.int32)
        first = greedy(model, params, cfg, prompt, 1)[0]
        eng = engine(cfg, params, n_slots=1, max_len=16, eos_id=first)
        r = Request(0, prompt, max_new=8)
        eng.serve([r])
        assert r.done and len(r.out) == 1

    @pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
    def test_rejects_non_kv_families(self, arch):
        cfg = get_smoke(arch)
        assert cfg.family not in SERVABLE_FAMILIES
        with pytest.raises(ValueError, match="Engine serves"):
            Engine(cfg, RUN, {}, device="cpu")

    def test_moe_is_servable_but_not_yet_built(self):
        """The engine builds for the MoE family and serves it: a smoke
        granite-moe request's greedy tokens equal repeated full forwards
        (a prompt of 8 and 4 new tokens: every group of at most 12
        tokens fits its experts' capacity of 8 choices, so chunked
        prefill and decode group the tokens without a drop, as the
        forward does).  Same servable families as the reference."""
        assert SERVABLE_FAMILIES == r_engine.SERVABLE_FAMILIES
        assert "moe" in SERVABLE_FAMILIES
        cfg = get_smoke("granite-moe-1b-a400m")
        model = build(cfg)
        params = init(model.spec, torch.Generator().manual_seed(0))
        eng = Engine(cfg, RUN, params, n_slots=2, max_len=32,
                     prefill_chunk=4, device="cpu")
        prompt = np.arange(3, 11, dtype=np.int32)
        req = Request(0, prompt, max_new=4)
        eng.serve([req])
        assert req.finish_reason == "length"
        assert req.out == greedy(model, params, cfg, prompt, 4)


class TestSchedulerInvariants:
    """Deterministic tick-by-tick simulation on a seeded arrival trace."""

    @pytest.fixture(scope="class")
    def served(self, setup):
        """One seeded Poisson trace driven with per-tick invariants; the
        assertions below all read this single simulation."""
        cfg, _, params = setup
        eng = engine(cfg, params, n_slots=2, max_len=16, prefill_chunk=4,
                     page_size=4)
        reqs = poisson_trace(8, rate=0.7, seed=3, vocab=cfg.vocab_size,
                             prompt_len=(2, 8), max_new=(2, 5))
        ticks = drive(eng, reqs)
        return eng, reqs, ticks

    def test_all_requests_complete_and_release(self, served):
        eng, reqs, _ = served
        assert all(r.status == "done" for r in reqs)
        assert eng.cache.n_used == 0 and eng.n_active == 0
        assert not eng.queue
        assert sorted(eng.cache.free) == list(range(eng.cache.n_pages))

    def test_fifo_admission_order(self, served):
        """Head-of-line FIFO: admission order is submission order."""
        _, reqs, _ = served
        by_submit = sorted(reqs, key=lambda r: (r.arrival, r.uid))
        admits = [r.admit_tick for r in by_submit]
        assert admits == sorted(admits)

    def test_no_starvation_bounded_queue_wait(self, served):
        """Every request is admitted, and with 2 slots the head of the
        queue waits at most the ticks the running pair needs to drain."""
        _, reqs, ticks = served
        assert all(r.admit_tick is not None for r in reqs)
        worst_service = max(
            -(-len(r.prompt) // 4) + r.max_new for r in reqs)  # chunks+decode
        waits = [r.admit_tick - r.arrival for r in reqs]
        assert max(waits) <= len(reqs) * worst_service
        assert ticks < 300

    def test_output_never_exceeds_max_new(self, served):
        _, reqs, _ = served
        assert all(1 <= len(r.out) <= r.max_new for r in reqs)

    def test_tick_stamps_are_consistent(self, served):
        """arrival ≤ admit ≤ first-token ≤ done on the tick clock, and
        the wall stamps exist and are ordered the same way."""
        _, reqs, _ = served
        for r in reqs:
            assert r.arrival <= r.admit_tick <= r.first_tick <= r.done_tick
            assert r.t_arrival <= r.t_first <= r.t_done

    def test_eos_frees_slot_same_tick(self, setup):
        """An EOS token retires the sequence in the tick that produced
        it: pages back on the free-list, slot reusable immediately."""
        cfg, model, params = setup
        prompt = np.array([2, 4], np.int32)
        first = greedy(model, params, cfg, prompt, 1)[0]
        eng = engine(cfg, params, n_slots=1, max_len=16, eos_id=first)
        r = Request(0, prompt, max_new=8)
        eng.submit(r)
        while not r.done:
            tick_with_invariants(eng)
        assert r.finish_reason == "eos"
        assert r.done_tick == r.first_tick       # EOS was the first token
        assert eng.cache.n_used == 0 and eng.n_active == 0


class TestFaults:
    """Reject-and-report, never wedge: every fault leaves the engine
    serving and the allocator clean."""

    @pytest.fixture()
    def eng(self, setup):
        cfg, _, params = setup
        return engine(cfg, params, n_slots=2, max_len=16, prefill_chunk=4,
                      page_size=4, queue_capacity=2)

    def test_empty_prompt_rejected(self, eng):
        r = Request(0, np.array([], np.int32))
        assert not eng.submit(r)
        assert (r.status, r.finish_reason) == ("rejected", "empty_prompt")
        assert not eng.queue

    def test_prompt_past_max_len_rejected(self, eng):
        r = Request(0, np.arange(17, dtype=np.int32))
        assert not eng.submit(r)
        assert (r.status, r.finish_reason) == ("rejected",
                                               "prompt_too_long")

    def test_queue_overflow_rejected(self, eng):
        reqs = [Request(i, np.array([1, 2], np.int32)) for i in range(3)]
        assert eng.submit(reqs[0]) and eng.submit(reqs[1])
        assert not eng.submit(reqs[2])
        assert reqs[2].finish_reason == "queue_full"
        assert len(eng.queue) == 2

    def test_faults_do_not_wedge_the_trace(self, setup):
        """A trace mixing good and bad requests still drains: the bad
        ones are rejected with reasons, the good ones complete."""
        cfg, _, params = setup
        eng = engine(cfg, params, n_slots=2, max_len=16, prefill_chunk=4,
                     page_size=4, queue_capacity=8)
        reqs = [Request(0, np.array([1, 2], np.int32), max_new=2),
                Request(1, np.array([], np.int32), max_new=2),
                Request(2, np.arange(99, dtype=np.int32), max_new=2),
                Request(3, np.array([3, 4, 5], np.int32), max_new=2)]
        stats = eng.run_trace(reqs)
        assert [r.status for r in reqs] == ["done", "rejected",
                                            "rejected", "done"]
        assert stats.n_completed == 2 and stats.n_rejected == 2
        assert not stats.gate()
        assert eng.cache.n_used == 0

    def test_cancel_queued_request(self, eng):
        r1 = Request(0, np.array([1, 2], np.int32))
        r2 = Request(1, np.array([3, 4], np.int32))
        eng.submit(r1), eng.submit(r2)
        assert eng.cancel(1)
        assert r2.status == "cancelled" and r2.done
        assert [q.uid for q in eng.queue] == [0]
        assert not eng.cancel(99)               # unknown uid: reported

    def test_cancel_midstream_frees_pages_immediately(self, setup):
        """Cancelling an active request releases its slot + pages the
        same call; the other in-flight request is undisturbed."""
        cfg, _, params = setup
        eng = engine(cfg, params, n_slots=2, max_len=16, prefill_chunk=4,
                     page_size=4)
        victim = Request(0, np.arange(8, dtype=np.int32), max_new=8)
        other = Request(1, np.array([1, 2], np.int32), max_new=3)
        eng.submit(victim), eng.submit(other)
        tick_with_invariants(eng)               # both admitted + running
        assert victim.status == "active" and eng.cache.n_used > 0
        used_before = eng.cache.n_used
        assert eng.cancel(0)
        eng.cache.check()
        assert victim.status == "cancelled" and victim.done
        assert eng.cache.n_used < used_before   # pages back immediately
        while not other.done:
            tick_with_invariants(eng)
        assert other.status == "done" and len(other.out) == 3
        assert eng.cache.n_used == 0

    def test_pool_exhaustion_truncates_instead_of_wedging(self, setup):
        """An undersized page pool finishes sequences ``truncated`` —
        graceful degrade, not a deadlock or a leak."""
        cfg, _, params = setup
        eng = engine(cfg, params, n_slots=2, max_len=16, prefill_chunk=4,
                     page_size=4, n_pages=2)
        reqs = [Request(i, np.array([1 + i, 2], np.int32), max_new=12)
                for i in range(2)]
        drive(eng, reqs)
        assert all(r.status == "done" for r in reqs)
        assert all(r.finish_reason == "truncated" for r in reqs)
        assert all(len(r.out) >= 1 for r in reqs)
        assert eng.cache.n_used == 0

    def test_injected_tick_fault_is_retried(self, setup, monkeypatch):
        """``REPRO_FAULTS=serve_fault:N`` raises a transient fault at tick
        N; the engine retries the tick (the hook fires before any state
        changes) and the trace completes as without it."""
        cfg, _, params = setup
        kw = dict(n_slots=2, max_len=16, prefill_chunk=4, page_size=4)

        def served(plan):
            monkeypatch.setenv(faults.FAULT_ENV, plan)
            eng = engine(cfg, params, **kw)
            reqs = poisson_trace(4, rate=1.0, seed=1, vocab=cfg.vocab_size,
                                 prompt_len=(2, 6), max_new=(2, 4))
            eng.run_trace(reqs)
            return eng, [(r.out, r.done_tick) for r in reqs]

        clean, want = served("")
        faulty, got = served("serve_fault:2")
        assert (clean.retried_ticks, faulty.retried_ticks) == (0, 1)
        assert got == want
        monkeypatch.setenv(faults.FAULT_ENV, "serve_fault:1x-1")
        with pytest.raises(faults.TransientFault, match="serve_fault:1"):
            engine(cfg, params, **kw).run_trace([
                Request(0, np.array([1, 2], np.int32), max_new=4)])


class TestEdgeCases:
    def test_prompt_exactly_max_len(self, setup):
        """A prompt at the context limit admits, yields exactly one
        token, and finishes ``truncated`` (no room for its K/V)."""
        cfg, _, params = setup
        eng = engine(cfg, params, n_slots=1, max_len=8, prefill_chunk=4,
                     page_size=4)
        r = Request(0, np.arange(8, dtype=np.int32), max_new=5)
        drive(eng, [r])
        assert r.status == "done" and r.finish_reason == "truncated"
        assert len(r.out) == 1
        assert eng.cache.n_used == 0

    def test_single_slot_serializes_a_trace(self, setup):
        cfg, _, params = setup
        eng = engine(cfg, params, n_slots=1, max_len=16, prefill_chunk=4,
                     page_size=4)
        reqs = [Request(i, np.array([1 + i, 2, 3], np.int32), max_new=2,
                        arrival=0) for i in range(3)]
        drive(eng, reqs)
        assert all(r.status == "done" for r in reqs)
        # one slot: service windows never overlap and preserve FIFO
        spans = sorted((r.admit_tick, r.done_tick) for r in reqs)
        for (_, d0), (a1, _) in zip(spans, spans[1:]):
            assert a1 >= d0

    def test_prefill_chunk_clamped_to_max_len(self, setup):
        cfg, _, params = setup
        eng = engine(cfg, params, n_slots=1, max_len=8, prefill_chunk=64)
        assert eng.chunk == 8

    def test_zero_slots_rejected(self, setup):
        cfg, _, params = setup
        with pytest.raises(ValueError, match="n_slots"):
            engine(cfg, params, n_slots=0)

    def test_the_card_is_the_default_and_params_must_live_there(
            self, setup):
        cfg, _, params = setup
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="'cuda' was asked for"):
                Engine(cfg, RUN, params)
        meta = {"w": torch.empty(2, device="meta")}
        with pytest.raises(ValueError, match="parameters live on"):
            Engine(cfg, RUN, meta, device="cpu")


class TestWorkload:
    def test_traces_are_seed_deterministic(self):
        a = poisson_trace(12, rate=0.5, seed=7, vocab=64)
        b = poisson_trace(12, rate=0.5, seed=7, vocab=64)
        assert [(r.uid, r.arrival, r.max_new, list(r.prompt))
                for r in a] == [(r.uid, r.arrival, r.max_new,
                                 list(r.prompt)) for r in b]
        c = poisson_trace(12, rate=0.5, seed=8, vocab=64)
        assert [r.arrival for r in a] != [r.arrival for r in c] or \
            [list(r.prompt) for r in a] != [list(r.prompt) for r in c]

    def test_trace_shapes_and_bounds(self):
        for tr in (poisson_trace(10, rate=1.0, seed=0, vocab=32,
                                 prompt_len=(2, 6), max_new=(1, 4)),
                   bursty_trace(10, rate=1.0, seed=0, vocab=32,
                                prompt_len=(2, 6), max_new=(1, 4))):
            assert len(tr) == 10
            arrivals = [r.arrival for r in tr]
            assert arrivals == sorted(arrivals)
            for r in tr:
                assert 2 <= len(r.prompt) <= 6
                assert 1 <= r.max_new <= 4
                assert np.all((r.prompt >= 0) & (r.prompt < 32))

    def test_make_trace_dispatch(self):
        assert make_trace("poisson", 3, rate=1.0, seed=0, vocab=8)
        assert make_trace("bursty", 3, rate=1.0, seed=0, vocab=8, burst=2)
        with pytest.raises(KeyError):
            make_trace("nope", 3, rate=1.0, seed=0, vocab=8)

    @pytest.mark.parametrize("kind,kw", [
        ("poisson", dict(rate=0.7)), ("bursty", dict(rate=0.3, burst=3))])
    @pytest.mark.parametrize("seed", [0, 11])
    def test_traces_equal_the_reference_per_seed(self, kind, kw, seed):
        def fields(tr):
            return [(r.uid, r.arrival, r.max_new, r.prompt.dtype.name,
                     r.prompt.tolist()) for r in tr]
        args = dict(seed=seed, vocab=500, prompt_len=(1, 40),
                    max_new=(2, 9), **kw)
        assert fields(make_trace(kind, 25, **args)) == \
            fields(r_workload.make_trace(kind, 25, **args))


# --------------------------------------------------------------------------
# the port against the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shared():
    """The reference's smoke minitron-4b parameters, in both packages."""
    r_cfg, p_cfg = r_get_smoke(ARCH), get_smoke(ARCH)
    params = r_init(jax.random.PRNGKey(0), r_build(r_cfg).spec)
    tp = from_jax_numpy(jax.tree.map(np.asarray, params))
    return r_cfg, p_cfg, params, tp


def _state(eng) -> tuple:
    return (eng.cache.page_table.tolist(), list(eng.cache.free),
            eng.cache.lengths.tolist(), eng.tick_count, dict(eng.calls))


def test_same_trace_same_tokens_ticks_and_pages_as_the_reference(shared):
    """O0, one seeded trace with more requests than slots, chunked
    prefill across page boundaries: driven tick by tick through both
    engines, the page tables, free-lists, fills and call counts agree
    after every tick; at the end the tokens, tick stamps and finish
    reasons do, and every page the port wrote is within the pools'
    tolerance of the reference's (module doc)."""
    _same_trace_both_engines(*shared, dict(n_slots=3, max_len=24,
                                           prefill_chunk=8, page_size=4),
                             prompt_len=(2, 20))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_same_trace_same_tokens_ticks_and_pages_as_the_reference(
        capacity_factor):
    """The same tick-by-tick comparison on the granite-moe smoke config
    (4 experts, top-2): each prefill chunk of 32 (its padded tail
    included) is one routing group, each decode slot's token another.  At
    the config's capacity factor a chunk's experts hold 24 of its 64
    choices each; at 0.5 they hold 8, so experts overflow in every chunk
    and the padded tail competes for the slots the stable sort leaves
    it, in both engines alike."""
    r_cfg, p_cfg = (dataclasses.replace(
        get("granite-moe-1b-a400m"), capacity_factor=capacity_factor)
        for get in (r_get_smoke, get_smoke))
    params = r_init(jax.random.PRNGKey(0), r_build(r_cfg).spec)
    tp = from_jax_numpy(jax.tree.map(np.asarray, params))
    _same_trace_both_engines(r_cfg, p_cfg, params, tp,
                             dict(n_slots=3, max_len=64, prefill_chunk=32,
                                  page_size=8), prompt_len=(2, 60))


def _same_trace_both_engines(r_cfg, p_cfg, params, tp, kw, prompt_len):
    r_eng = r_engine.Engine(r_cfg, RRunConfig(amp="O0"), params, **kw)
    p_eng = Engine(p_cfg, RunConfig(amp="O0"), tp, device="cpu", **kw)
    tk = dict(rate=0.8, seed=5, vocab=r_cfg.vocab_size,
              prompt_len=prompt_len, max_new=(2, 8))
    r_reqs = r_workload.poisson_trace(10, **tk)
    p_reqs = poisson_trace(10, **tk)
    pend_r, pend_p = list(r_reqs), list(p_reqs)
    for _ in range(200):
        while pend_r and pend_r[0].arrival <= r_eng.tick_count:
            assert r_eng.submit(pend_r.pop(0)) == p_eng.submit(pend_p.pop(0))
        if not pend_r and not r_eng.queue and r_eng.n_active == 0:
            break
        r_eng.tick()
        p_eng.tick()
        assert _state(p_eng) == _state(r_eng)
    assert all(r.status == "done" for r in p_reqs)
    assert [(r.out, r.admit_tick, r.first_tick, r.done_tick,
             r.finish_reason) for r in p_reqs] == \
        [(r.out, r.admit_tick, r.first_tick, r.done_tick, r.finish_reason)
         for r in r_reqs]
    # the reference's -1 writes land in its last page (JAX normalizes the
    # negative index before the drop test); the port drops them, so that
    # page, never allocated here, is compared apart
    n = p_eng.cache.n_pages
    for r_pool, p_pool in ((r_eng.cache.k_pool, p_eng.cache.k_pool),
                           (r_eng.cache.v_pool, p_eng.cache.v_pool)):
        want = np.asarray(r_pool, np.float32)[:, :n - 1]
        np.testing.assert_allclose(p_pool[:, :n - 1].float().numpy(), want,
                                   atol=1e-4, rtol=2.0 ** -7)
        assert not p_pool[:, n - 1].any()
        assert np.abs(np.asarray(r_pool, np.float32)[:, n - 1]).max() > 0


def test_padding_and_inactive_slots_write_no_other_page(setup):
    """A page id of -1 drops the write.  A padded prefill chunk and a
    decode tick with inactive slots leave every page but the ones the
    writing slot owns bit-identical — the pool's last page included,
    where a wrapped -1 index would land."""
    cfg, _, params = setup
    eng = engine(cfg, params, n_slots=3, max_len=16, prefill_chunk=8,
                 page_size=4, run=RunConfig(amp="O0"))
    g = torch.Generator().manual_seed(1)
    for store in (eng.cache.k_store, eng.cache.v_store):
        store.copy_(torch.randn(store.shape, generator=g))
    # slot 1 takes pages from the free-list's end: the pool's last page
    # is free and its contents random, as any other page's
    before = [t.clone() for t in (eng.cache.k_pool, eng.cache.v_pool)]
    r = Request(0, np.array([1, 2, 3], np.int32), max_new=3)
    eng.submit(r)
    eng.tick()                       # prefill: 3 valid of 8, then decode
    owned = eng.cache.slot_pages(0)
    assert len(r.out) == 2 and eng.calls == {
        "prefill_first": 1, "prefill_ext": 0, "decode": 1}
    assert owned == [0]
    assert eng.cache.n_pages - 1 not in owned
    for old, new in zip(before, (eng.cache.k_pool, eng.cache.v_pool)):
        others = [p for p in range(eng.cache.n_pages) if p not in owned]
        assert torch.equal(new[:, others], old[:, others])
        # slot 0's first page: rows 0..3 written (3 prompt + 1 decoded)
        assert not torch.equal(new[:, owned[0]], old[:, owned[0]])


def test_out_of_range_reads_clamp_and_writes_drop():
    """The reference's gathers clamp (a -1 table entry reads page 0) and
    its scatters drop a write past the pool: the port's cache helpers do
    both."""
    cfg = get_smoke(ARCH)
    cache = PagedKVCache(cfg, n_slots=2, max_len=8, page_size=4,
                         dtype=torch.float32, device="cpu")
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    k = torch.arange(L * 6 * K * hd, dtype=torch.float32).reshape(
        L, 6, K, hd)
    cache.write(1, 0, k, -k)
    assert cache.slot_pages(1) == [0, 1]
    kk, vv = cache.read(1)
    assert torch.equal(kk, k) and torch.equal(vv, -k)
    pages, offs = cache.write_coords(1, 6, 4)      # positions 6..9
    assert pages.tolist() == [1, 1, -1, -1] and offs.tolist() == [2, 3, 0, 1]
    # slot 0 owns nothing: its dense view reads page 0 (the clamp)
    assert torch.equal(cache.read(0, 4)[0], k[:, :4])
    assert not cache.k_store[:, cache.n_pages].any()


def test_stats_summary_equals_the_reference():
    rng = np.random.default_rng(3)
    reqs_p, reqs_r = [], []
    for i, status in enumerate(["done", "done", "rejected", "cancelled",
                                "done", "done"]):
        t0 = float(rng.uniform(0, 1))
        kw = dict(uid=i, prompt=np.arange(3, dtype=np.int32), max_new=5,
                  out=list(range(int(rng.integers(1, 5)))), done=True,
                  arrival=i, status=status, admit_tick=i + 1,
                  t_arrival=t0, t_first=t0 + float(rng.uniform(0, 1)),
                  t_done=t0 + 2.0)
        reqs_p.append(Request(**kw))
        reqs_r.append(r_engine.Request(**kw))
    a = metrics.stats_from_requests(reqs_p, wall_s=3.5, ticks=12,
                                    prefill_wall_s=1.0, decode_wall_s=2.0)
    b = r_metrics.stats_from_requests(reqs_r, wall_s=3.5, ticks=12,
                                      prefill_wall_s=1.0, decode_wall_s=2.0)
    assert a.summary() == b.summary()
    assert a.render() == b.render() and a.gate() == b.gate()
    assert metrics.percentile([3, 1, 2], 50) == r_metrics.percentile(
        [3, 1, 2], 50)


def test_serve_record_parses_and_diffs_through_the_reference(tmp_path,
                                                            monkeypatch):
    """``Session(device="cpu").serve`` end to end: a ``serve/<config>``
    record with prefill and decode phases, read by ``repro.trace.store``;
    a second run with its walls doubled is flagged by
    ``repro.trace.compare`` in both phases."""
    s = Session(device="cpu", workspace=str(tmp_path))
    kw = dict(n_requests=6, max_len=32, prefill_chunk=8, n_slots=2,
              prompt_len=(4, 20), max_new=(2, 5))
    res = s.serve("glm4-9b", **kw)
    rec, stats, eng, reqs = res.data
    assert res.exit_code == 0 and stats.n_completed == 6
    assert all(r.finish_reason == "length" for r in reqs)
    assert res.name == "serve/glm4-9b" and set(res.phases) == {
        "prefill", "decode"}
    assert set(res.analyses) == {n for n, c in eng.calls.items() if c}
    # the walk of each executable, scaled by its calls: the decode phase
    # is one call's walk times the ticks that decoded
    one = res.analyses["decode"]
    assert res.phases["decode"]["flops"] == one.total_flops * \
        eng.calls["decode"]
    assert res.phases["decode"]["launches"] == eng.calls["decode"] * sum(
        k.exec_count for k in one.kernels)
    assert trace.memory_bound_fraction(res.phases["decode"]) > 0.5

    # a second run whose every call takes twice as long: the engine's
    # walls replaced by fixed ones, so host noise cannot flag or hide it
    real = trace.executable_measurement

    def fixed(per_call):
        return lambda name, r, m, wall, n: real(name, r, m, per_call * n, n)

    monkeypatch.setattr(trace, "executable_measurement", fixed(0.005))
    rec = s.serve("glm4-9b", **kw).data[0]
    monkeypatch.setattr(trace, "executable_measurement", fixed(0.010))
    slow = s.serve("glm4-9b", **kw).data[0]
    recs = {r.run_id: r for r in
            r_store.TraceStore(s.workspace.trace_path).records()}
    assert len(recs) == 3 and {rec.run_id, slow.run_id} <= set(recs)
    base = recs[rec.run_id]
    assert base.config == "serve/glm4-9b" and list(base.phases) == [
        "prefill", "decode"]
    for payload in base.phases.values():
        assert set(r_store.PHASE_METRICS) <= set(payload)
        assert payload["wall_s"] > 0 and payload["launches"] > 0
    assert base.meta["serve"]["completed"] == 6
    assert base.meta["prefill_chunk"] == 8
    # the tokens are the same (same seed), the walls doubled: regressions
    flagged = r_compare.regressions(r_compare.compare_records(
        base, recs[slow.run_id]))
    assert {(d.phase, d.metric) for d in flagged} >= {
        ("prefill", "wall_s"), ("decode", "wall_s")}
    assert s.report("serve/glm4-9b").data.run_id == slow.run_id


def test_cli_serve_on_the_host(tmp_path):
    """``python -m repro_torch serve --device cpu`` serves and stores a
    record; without ``--device`` it asks for the card."""
    store = str(tmp_path / "t.jsonl")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")

    def run(*argv):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch", "serve", "--config",
             "glm4-9b", "--requests", "4", "--max-len", "32", "--store",
             store, *argv], cwd=REPO_ROOT, env=env, capture_output=True,
            text=True, timeout=300)

    out = run("--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "[record] serve/glm4-9b" in out.stdout
    assert "4/4 completed" in out.stdout
    assert [r.config for r in r_store.TraceStore(store).records()] == [
        "serve/glm4-9b"]
    if not torch.cuda.is_available():
        out = run()
        assert out.returncode == 2 and "'cuda' was asked for" in out.stderr

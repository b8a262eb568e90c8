"""One replica's decode plane: slots, prefill/decode, retire — the port
of ``horovod_tpu/serve/engine.py``.

Two programs serve every request mix, because request variety is data,
not shape (PyTorch runs them eagerly; there is no ``jit``):

* ``prefill`` — (1, max_prompt_len) tokens + a length: the prompt's KV
  lines land in a single-slot cache, the pad lines are then invalidated,
  and the first output token is sampled at position ``length - 1``. The
  cache may arrive WARM at a base position — the shared-prefix fork
  (``serve/prefix.py``) imports a stored prefix blob and prefills only
  the remainder; base 0 is the fresh-prompt case. Admission copies the
  slot into the batch cache (``kvcache.write_slot``).
* ``decode`` — one token per slot across ALL slots: (slots, 1) last
  tokens against the (slots, max_len, ...) ring cache. Empty slots
  decode garbage that is never read.

Three optional levers extend the plane without changing its shape:

* **shared-prefix forks** — ``prefix_cache=`` (one
  :class:`~.prefix.PrefixCache` shared by the cluster's replicas): a
  stored common prefix is an exact slot copy (no codec, no kernel), so
  only the remainder prefills.
* **tp-sharded decode** — ``parallel=`` (a ParallelSpec with a tp axis)
  and a model built with the same ``tp_axis``: this process is one tp
  rank, its cache holds its own heads (``models.gpt.init_kv_cache``) and
  the row-parallel output projection is the block's one allreduce. Every
  rank of a tp replica runs the same engine over the same requests in
  the same order; the allreduce gives every rank the same logits, so
  every rank samples the same tokens. A handoff codes each rank's own
  head shard (one grouped K2 and one K4 launch a side a rank).
* **speculative decoding** — ``draft_model``/``spec_k`` add a draft
  propose (k greedy decode calls of the draft over its own ring, the
  drafts kept on the device) + target verify (ONE batched (slots, k)
  incremental step) + cache rewind per round, with one host transfer a
  round. Greedy acceptance emits exactly the tokens the
  non-speculative engine would (by induction: a greedy token is only
  committed when its full context matched the true rollout). The
  brownout ladder's ``spec_off`` rung flips ``spec_enabled``.

Sampling: greedy argmax is the parity contract with the JAX package
(bit-identical token streams for the same weights and trace). With
``temperature > 0`` a token is drawn from ``softmax(logits / T)`` with a
``torch.Generator`` seeded from ``(seed, rid, position)`` alone — so it is
deterministic under re-batching and migration, but the draws differ
from the JAX package's ``jax.random`` lane: sampled parity is not
claimed.

Each decode round is bracketed with flight-recorder events (op
``serve``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..common import flightrec as flightrec_lib
from ..common import metrics as metrics_lib
from ..common.device import resolve_device
from . import kvcache as kv_lib
from . import tracing
from .queue import Request, record_completion

_M_TOKENS = metrics_lib.counter(
    "hvd_tpu_serve_tokens_total",
    "tokens processed by the serve engines, by kind "
    "(prompt = prefilled, generated = decoded)",
    labels=("kind",))
for _k in ("prompt", "generated"):
    _M_TOKENS.labels(kind=_k)
del _k
_M_ACTIVE = metrics_lib.gauge(
    "hvd_tpu_serve_active_requests",
    "requests currently holding a decode slot, summed over this "
    "process's replicas")
_M_CACHE_BYTES = metrics_lib.gauge(
    "hvd_tpu_serve_kv_cache_bytes",
    "allocated KV-cache bytes, by replica (int8 storage shows the "
    "~4x reduction over fp32 here)",
    labels=("replica",))

_M_SPEC = metrics_lib.counter(
    "hvd_tpu_serve_spec_tokens_total",
    "speculative-decode draft tokens by verification outcome "
    "(accepted / rejected) — accepted / (accepted + rejected) is the "
    "draft acceptance rate",
    labels=("outcome",))
for _o in ("accepted", "rejected"):
    _M_SPEC.labels(outcome=_o)
del _o


def _axis_name(axis) -> Optional[str]:
    """A tp axis given as a mesh axis name or an ``Axis``, by name."""
    return getattr(axis, "name", axis) if axis else None


def _tp_spec(parallel):
    """``parallel`` (a ParallelSpec, its string or dict form, or None)
    as a ParallelSpec with a tp axis, else None."""
    if parallel is None:
        return None
    from ..parallel.spec import ParallelSpec

    spec = ParallelSpec.resolve(parallel)
    return spec if spec is not None and spec.tp_axis else None


def _check_tp(model, spec) -> None:
    """A tp engine needs a model sharded over the spec's tp axis and a
    world whose tp axis has the spec's size."""
    if _axis_name(getattr(model, "tp_axis", None)) != spec.tp_axis:
        raise ValueError(
            f"parallel spec shards heads over {spec.tp_axis!r} but the "
            f"model's tp_axis is {getattr(model, 'tp_axis', None)!r} — "
            "construct the model with the matching axis (models/gpt.py)")
    from ..ops import collectives as C

    size = C._axis(model.tp_axis).size
    if size != spec.size_of(spec.tp_axis):
        raise ValueError(
            f"parallel spec {spec.describe()} wants tp = "
            f"{spec.size_of(spec.tp_axis)} but this world's "
            f"{spec.tp_axis!r} axis has {size} ranks; init(parallel=) "
            "with the same spec")


def tp_rank(parallel) -> int:
    """This process's index on ``parallel``'s tp axis (0 without one):
    the rank of a tp replica that writes its logs."""
    spec = _tp_spec(parallel)
    if spec is None:
        return 0
    from ..ops import collectives as C

    return C._axis(spec.tp_axis).index


class DecodeEngine:
    """Slots + cache + prefill/decode for ONE replica.

    ``model`` is the port's GPT (``models/gpt.py``); ``params`` an
    optional state dict loaded into it (e.g. from
    ``models.convert.gpt_params_from_jax``). ``device`` defaults to
    ``"cuda"`` and raises without a GPU unless ``"cpu"`` is passed; the
    model is moved there. Greedy decode by default; ``eos_id`` (optional)
    ends a sequence early, ``max_new_tokens`` always bounds it.

    ``parallel`` (a ParallelSpec with a tp axis, or its string form)
    runs this engine as one tp rank of a replica — the model must carry
    the same ``tp_axis`` and the params stay the dense state dict.
    ``prefix_cache`` (a shared :class:`~.prefix.PrefixCache`) turns
    common prompt prefixes into slot forks instead of re-prefill.
    ``draft_model``/``draft_params`` (a state dict for the draft)/
    ``spec_k`` enable greedy speculative decoding (draft proposes k,
    target verifies in one batched step); the draft must share the
    target's vocab and runs on the engine's device.
    """

    def __init__(self, model, params=None, slots: int = 4,
                 max_len: int = 32, max_prompt_len: int = 16,
                 kv_kind: str = "fp32", eos_id: Optional[int] = None,
                 name: str = "r0", device=None, parallel=None,
                 prefix_cache=None, draft_model=None, draft_params=None,
                 spec_k: int = 0):
        if max_prompt_len > max_len:
            raise ValueError(
                f"max_prompt_len {max_prompt_len} exceeds the cache's "
                f"max_len {max_len}")
        from ..models.gpt import init_kv_cache

        self.device = resolve_device(device)
        self.parallel = _tp_spec(parallel)
        self.prefix_cache = prefix_cache
        self.spec_k = int(spec_k) if draft_model is not None else 0
        # Runtime gate the brownout ladder's spec_off rung flips:
        # speculation pauses without discarding the draft state, and the
        # plain rounds keep the draft ring mirrored so re-enabling is
        # exact.
        self.spec_enabled = True
        if self.spec_k and self.parallel is not None:
            raise ValueError(
                "speculative decoding and tp-sharded decode are "
                "separate serve levers; enable one per engine")
        if self.parallel is not None:
            _check_tp(model, self.parallel)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.max_prompt_len = int(max_prompt_len)
        self.kv_kind = kv_kind
        self.eos_id = eos_id
        self.name = name
        self.cache = init_kv_cache(model, self.slots, self.max_len,
                                   kind=kv_kind, device=self.device)
        # The prefill's single-slot scratch cache, reset before each
        # prefill. A fresh prefill writes lines [0, max_prompt_len) and
        # the lines past them stay zero, as in the JAX package's fresh
        # all-zero template (the handoff codes the whole slot, so they
        # matter); a fork imports a whole stored slot and writes past
        # them, so the next fresh prefill zeroes them again.
        self._single = init_kv_cache(model, 1, self.max_len,
                                     kind=kv_kind, device=self.device)
        self._single_dirty = False
        _M_CACHE_BYTES.labels(replica=name).set(
            kv_lib.cache_nbytes(self.cache))
        self.requests: List[Optional[Request]] = [None] * self.slots
        self.generated: List[List[int]] = [[] for _ in range(self.slots)]
        self.last_tokens = np.zeros((self.slots,), np.int32)
        # The host's copy of cache["pos"] (every slot's write head), so
        # a speculative round decides without reading the device.
        self._pos = np.zeros((self.slots,), np.int64)
        self.decode_steps = 0
        # Prefill work actually computed (prefix forks subtract the
        # forked tokens).
        self.prefill_tokens = 0
        self.draft_model = draft_model
        if self.spec_k:
            if getattr(draft_model, "vocab_size", None) \
                    != model.vocab_size:
                raise ValueError(
                    "draft and target must share a vocab: draft "
                    f"{getattr(draft_model, 'vocab_size', None)} vs "
                    f"target {model.vocab_size}")
            if draft_params is not None:
                draft_model.load_state_dict(draft_params)
            self.draft_model = draft_model.to(self.device).eval()
            # The draft's caches hold the model dtype always (the fp32
            # kind), whatever the target's kind, as in the JAX package.
            self.draft_cache = init_kv_cache(
                draft_model, self.slots, self.max_len, kind="fp32",
                device=self.device)
            self._draft_single = init_kv_cache(
                draft_model, 1, self.max_len, kind="fp32",
                device=self.device)
            self.spec_rounds = 0
            self.spec_fallback_rounds = 0
            self.spec_proposed = 0
            self.spec_accepted = 0

    # -- admission -----------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is None]

    def active_count(self) -> int:
        return self.slots - len(self.free_slots())

    def admit(self, req: Request, now: float = 0.0) -> int:
        """Prefill ``req`` into a free slot; returns the slot. The prompt
        is truncated to the engine's ``max_prompt_len`` trailing
        window. With a ``prefix_cache``, a stored common prefix forks
        through an exact slot copy (import + rewind) and only the
        remainder prefills; the prompt-token accounting counts the
        remainder."""
        free = self.free_slots()
        if not free:
            raise RuntimeError(f"replica {self.name}: no free slot")
        slot = free[0]
        prompt = list(req.prompt)[-self.max_prompt_len:]
        base = 0
        kv_lib.reset_slot(self._single, 0)
        if self.prefix_cache is not None:
            hit = self.prefix_cache.lookup(prompt)
            # The pad lines of the remainder prefill land at positions
            # base .. base + max_prompt_len - 1; refuse a fork that
            # would ring-wrap them over the reused prefix lines.
            if hit is not None \
                    and hit[0] + self.max_prompt_len <= self.max_len:
                base, blob = hit
                kv_lib.import_slot(self._single, 0, blob)
                kv_lib.rewind_slots(self._single, torch.full(
                    (1,), base, dtype=torch.int32, device=self.device))
                self._single_dirty = True
                self.prefix_cache.note_hit(base)
        if not base and self._single_dirty:
            for layer in self._single["layers"]:
                for leaf in layer.values():
                    leaf[:, self.max_prompt_len:].zero_()
            self._single_dirty = False
        remainder = prompt[base:]
        single, first = _prefill_fn(
            self.model, self._padded(remainder), len(remainder),
            self._single, req.temperature, req.sample_seed & 0x7FFFFFFF,
            req.rid)
        if self.prefix_cache is not None and base == 0 \
                and len(prompt) > 1:
            # Fresh full prefills only, as an exact slot copy: a later
            # fork then decodes as a fresh prefill would.
            self.prefix_cache.insert(
                tuple(prompt), kv_lib.export_slot(single, 0, exact=True))
        kv_lib.write_slot(self.cache, slot, single)
        self._pos[slot] = base + len(remainder)
        if self.spec_k:
            # Warm the draft's ring for this slot from the FULL prompt:
            # its positions must mirror the target's.
            kv_lib.reset_slot(self._draft_single, 0)
            _prefill_cache(self.draft_model, self._padded(prompt),
                           len(prompt), self._draft_single)
            kv_lib.write_slot(self.draft_cache, slot, self._draft_single)
        self.requests[slot] = req
        req.replica = self.name
        req.first_token_t = now
        self.generated[slot] = [first]
        self.last_tokens[slot] = first
        self.prefill_tokens += len(remainder)
        _M_TOKENS.labels(kind="prompt").inc(len(remainder))
        _M_TOKENS.labels(kind="generated").inc()
        _M_ACTIVE.inc()
        tr = tracing.tracer()
        if tr.enabled:
            if base:
                tr.prefix_fork(req.rid, self.name, now, base)
            tr.prefill(req, self.name, now, len(remainder))
        return slot

    def _padded(self, tokens) -> torch.Tensor:
        """``tokens`` as a (1, max_prompt_len) zero-padded row on the
        engine's device."""
        padded = np.zeros((1, self.max_prompt_len), np.int64)
        padded[0, :len(tokens)] = tokens
        return torch.from_numpy(padded).to(self.device)

    def _last_tokens(self) -> torch.Tensor:
        return torch.from_numpy(self.last_tokens.astype(np.int64)).to(
            self.device)

    # -- the decode step -----------------------------------------------------

    def step(self, now: float = 0.0) -> List[Request]:
        """One decode round across every slot; retires and returns the
        requests that finished this step. With speculative decoding the
        round emits up to ``spec_k`` tokens per slot (the tokens of the
        1-token rounds); rounds that cannot speculate safely, or run
        while ``spec_enabled`` is off, fall back to the plain step."""
        if self.active_count() == 0:
            return []
        if self.spec_k and self.spec_enabled and self._spec_ready():
            return self._spec_step(now)
        last = self._last_tokens()
        if self.spec_k:
            self.spec_fallback_rounds += 1
            # Keep the draft's ring mirrored through plain rounds so
            # later speculative rounds see the true context.
            self.draft_model(last[:, None], cache=self.draft_cache)
        rec = flightrec_lib.recorder()
        step_name = f"serve.decode.{self.name}"
        rec.record_submit(step_name, "serve")
        temps = np.zeros((self.slots,), np.float32)
        seeds = np.zeros((self.slots,), np.int64)
        rids = np.zeros((self.slots,), np.int64)
        poss = np.zeros((self.slots,), np.int64)
        for slot, req in enumerate(self.requests):
            if req is None:
                continue
            temps[slot] = req.temperature
            seeds[slot] = req.sample_seed & 0x7FFFFFFF
            rids[slot] = req.rid
            poss[slot] = len(self.generated[slot])
        try:
            next_np = _decode_fn(self.model, self.cache, last, temps,
                                 seeds, rids, poss)
        except BaseException:
            rec.record_complete(step_name, outcome="error")
            raise
        self._pos += 1
        rec.annotate(step_name,
                     nbytes=kv_lib.cache_nbytes(self.cache),
                     wire=self.kv_kind,
                     trace=self._trace_csv() if rec.enabled else None)
        rec.record_complete(step_name)
        self.decode_steps += 1
        finished: List[Request] = []
        for slot, req in enumerate(self.requests):
            if req is None:
                continue
            if len(self.generated[slot]) >= req.max_new_tokens:
                # The finishing token came from the PREVIOUS round (or
                # prefill); this round's output for the slot is dropped.
                done = True
            else:
                tok = int(next_np[slot])
                self.generated[slot].append(tok)
                self.last_tokens[slot] = tok
                _M_TOKENS.labels(kind="generated").inc()
                done = (len(self.generated[slot]) >= req.max_new_tokens
                        or (self.eos_id is not None
                            and tok == self.eos_id))
            if done:
                finished.append(self.retire(slot, now))
        return finished

    # -- speculative decoding ------------------------------------------------

    def _spec_ready(self) -> bool:
        """A round may speculate iff every active slot is greedy
        (temperature 0 — the acceptance rule is exact only for argmax)
        and no slot's k-token burst would ring-wrap: a wrapped write
        overwrites the oldest line, and the post-verify rewind cannot
        restore what was overwritten."""
        for slot, req in enumerate(self.requests):
            if req is None:
                continue
            if req.temperature > 0.0:
                return False
            if int(self._pos[slot]) + self.spec_k > self.max_len:
                return False
        return True

    def _spec_step(self, now: float) -> List[Request]:
        """One speculative round: the draft proposes ``spec_k`` tokens
        per slot (k greedy decode calls over its own ring, the drafts
        kept on the device), the target verifies them in ONE batched
        (slots, k) incremental step, and the longest greedily-matching
        prefix commits — plus the target's own correction token, so
        every round emits at least one token and at most k. Both rings
        then rewind to the committed position. The greedy and draft
        tokens come to the host in one transfer."""
        k = self.spec_k
        rec = flightrec_lib.recorder()
        step_name = f"serve.decode.{self.name}"
        rec.record_submit(step_name, "serve")
        pos_before = self._pos.copy()
        try:
            last = self._last_tokens()
            toks, drafts = last, []
            for _ in range(k):
                logits, _ = self.draft_model(toks[:, None],
                                             cache=self.draft_cache)
                toks = torch.argmax(logits[:, 0].to(torch.float32),
                                    dim=-1)
                drafts.append(toks)
            proposed = torch.stack(drafts, dim=1)          # (slots, k)
            # Verify feeds [t_n, d_1 .. d_{k-1}]: position i's logits
            # see the context up to draft i, so greedy[i] is the true
            # next token GIVEN that context.
            verify_in = torch.cat([last[:, None], proposed[:, :k - 1]],
                                  dim=1)
            logits, _ = self.model(verify_in, cache=self.cache)
            greedy = torch.argmax(logits.to(torch.float32), dim=-1)
            g, d = torch.stack([greedy, proposed]).cpu().numpy()
        except BaseException:
            rec.record_complete(step_name, outcome="error")
            raise
        new_pos = np.zeros((self.slots,), np.int64)
        finished: List[Request] = []
        done_slots: List[int] = []
        tr = tracing.tracer()
        for slot, req in enumerate(self.requests):
            if req is None:
                continue
            new_pos[slot] = pos_before[slot]
            if len(self.generated[slot]) >= req.max_new_tokens:
                # Finishing token produced by a previous round; this
                # round's output for the slot is discarded (the plain
                # step's rule).
                done_slots.append(slot)
                continue
            m = 0
            while m < k - 1 and d[slot, m] == g[slot, m]:
                m += 1
            self.spec_proposed += k
            self.spec_accepted += m
            _M_SPEC.labels(outcome="accepted").inc(m)
            _M_SPEC.labels(outcome="rejected").inc(k - m)
            if tr.enabled:
                tr.spec_round(req.rid, self.name, now, m, k)
            committed = 0
            done = False
            for i in range(m + 1):
                tok = int(g[slot, i])
                self.generated[slot].append(tok)
                self.last_tokens[slot] = tok
                committed += 1
                _M_TOKENS.labels(kind="generated").inc()
                done = (len(self.generated[slot]) >= req.max_new_tokens
                        or (self.eos_id is not None
                            and tok == self.eos_id))
                if done:
                    break
            new_pos[slot] = pos_before[slot] + committed
            if done:
                done_slots.append(slot)
        rewind = torch.from_numpy(new_pos).to(self.device)
        kv_lib.rewind_slots(self.cache, rewind)
        kv_lib.rewind_slots(self.draft_cache, rewind)
        self._pos[:] = new_pos
        for slot in done_slots:
            finished.append(self.retire(slot, now))
        rec.annotate(step_name,
                     nbytes=kv_lib.cache_nbytes(self.cache),
                     wire=self.kv_kind,
                     trace=self._trace_csv() if rec.enabled else None)
        rec.record_complete(step_name)
        self.decode_steps += 1
        self.spec_rounds += 1
        return finished

    def spec_acceptance_rate(self) -> float:
        """Accepted draft tokens / proposed draft tokens over this
        engine's speculative rounds (0 when none ran)."""
        return (self.spec_accepted / self.spec_proposed
                if self.spec_k and self.spec_proposed else 0.0)

    def _trace_csv(self) -> str:
        """Active request ids as a CSV (the flight recorder's trace
        stamp per decode event)."""
        return ",".join(str(r.rid) for r in self.requests
                        if r is not None)

    def request_done(self, slot: int) -> bool:
        """True when the slot's sequence already hit its stop condition
        (a 1-token request finishes at prefill)."""
        req = self.requests[slot]
        if req is None:
            return False
        toks = self.generated[slot]
        return bool(len(toks) >= req.max_new_tokens
                    or (self.eos_id is not None and toks
                        and toks[-1] == self.eos_id))

    def retire(self, slot: int, now: float) -> Request:
        req = self.requests[slot]
        req.tokens = tuple(self.generated[slot])
        req.finish_t = now
        record_completion(req)
        tracing.tracer().retire(req, self.name, now)
        self._free_slot(slot)
        return req

    def _free_slot(self, slot: int) -> None:
        """Empty ``slot``: its request, tokens and cache lines (the
        draft's too)."""
        self.requests[slot] = None
        self.generated[slot] = []
        kv_lib.reset_slot(self.cache, slot)
        self._pos[slot] = 0
        if self.spec_k:
            kv_lib.reset_slot(self.draft_cache, slot)
        _M_ACTIVE.dec()

    # -- drain / teardown ----------------------------------------------------

    def abort_all(self, now: Optional[float] = None) -> List[Request]:
        """Hard abort (replica kill): every in-flight request comes back
        UNFINISHED for re-routing; the peer re-prefills from the
        prompt."""
        out = []
        tr = tracing.tracer()
        for slot, req in enumerate(self.requests):
            if req is None:
                continue
            if tr.enabled:
                tr.abort(req, self.name, now)
            req.reroutes += 1
            req.replica = None
            out.append(req)
            self._free_slot(slot)
        return out

    def export_slot(self, slot: int) -> Dict[str, Any]:
        """A slot's warm cache as the int8 block-scaled wire blob
        (``kvcache.export_slot`` — kernel K2 on a GPU); on a tp rank,
        this rank's head shard."""
        return kv_lib.export_slot(self.cache, slot)

    def migrate_out(self, slot: int, now: Optional[float] = None,
                    kind: str = "migrate"):
        """Evict one in-flight sequence WITH its warm state: returns
        ``(request, wire_blob, generated_tokens)``. The slot frees
        immediately. With tracing on, the trace stamp rides the blob
        (top-level ``"trace"`` key)."""
        req = self.requests[slot]
        if req is None:
            raise RuntimeError(f"replica {self.name}: slot {slot} empty")
        blob = kv_lib.export_slot(self.cache, slot)
        tr = tracing.tracer()
        if tr.enabled:
            stamp = tr.export(req, self.name, now, kind)
            if stamp is not None:
                blob["trace"] = stamp
        generated = list(self.generated[slot])
        self._free_slot(slot)
        return req, blob, generated

    def admit_migrated(self, req: Request, blob: Dict[str, Any],
                       generated, now: float = 0.0) -> int:
        """Land a migrated sequence in a free slot: the wire blob imports
        into the cache (``kvcache.import_slot`` — kernel K4 on a GPU) and
        decode continues from the last generated token, no re-prefill.
        With speculative decoding the draft ring gets no warm state (the
        wire carries the target cache only): proposals for the slot
        degrade until it retires, and the verify step keeps the output
        exact."""
        free = self.free_slots()
        if not free:
            raise RuntimeError(f"replica {self.name}: no free slot")
        slot = free[0]
        stamp = blob.pop("trace", None) if isinstance(blob, dict) else None
        kv_lib.import_slot(self.cache, slot, blob)
        self._pos[slot] = int(blob["pos"])
        tr = tracing.tracer()
        if tr.enabled:
            tr.import_blob(req, self.name, now, stamp)
        self.requests[slot] = req
        req.replica = self.name
        req.migrations += 1
        self.generated[slot] = list(generated)
        self.last_tokens[slot] = generated[-1] if generated else 0
        _M_ACTIVE.inc()
        return slot

    def close(self) -> None:
        """Zero this replica's labeled gauges when it leaves the
        cluster."""
        _M_CACHE_BYTES.labels(replica=self.name).set(0)


def _sample_token(row: torch.Tensor, temp: float, seed: int, rid: int,
                  pos: int) -> int:
    """One slot's next token: greedy argmax at ``temp == 0``, else a
    categorical draw from ``softmax(row / temp)`` under a generator
    seeded from ``(seed, rid, pos)`` alone — never the slot or replica."""
    row = row.to(torch.float32)
    if temp <= 0.0:
        return int(torch.argmax(row))
    gen = torch.Generator(device=row.device)
    gen.manual_seed(((int(seed) * 1_000_003 + int(rid)) * 1_000_003
                     + int(pos)) & 0x7FFF_FFFF_FFFF_FFFF)
    probs = torch.softmax(row / max(float(temp), 1e-6), dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))


def _prefill_cache(model, tokens: torch.Tensor, length: int,
                   single_cache: Dict[str, Any]):
    """(1, P) padded tokens into a single-slot cache from its write head
    (the BASE: 0 for a fresh prompt, the stored prefix length for a
    fork). All P lines are written; the pad lines (positions >= base +
    length) are then invalidated and the write head rewinds to the true
    end — the JAX engine's pad-then-invalidate semantics exactly.
    Returns the (1, P, vocab) logits."""
    base = single_cache["pos"].clone()                 # (1,) int32
    logits, cache = model(tokens, cache=single_cache)
    kv_lib.rewind_slots(cache, base + int(length))
    return logits


def _prefill_fn(model, tokens: torch.Tensor, length: int,
                single_cache: Dict[str, Any], temp: float, seed: int,
                rid: int):
    """(1, P) padded prompt -> (single-slot cache, first output token)."""
    logits = _prefill_cache(model, tokens, length, single_cache)
    first = _sample_token(logits[0, length - 1], temp, seed, rid, 0)
    return single_cache, first


def _decode_fn(model, cache: Dict[str, Any], last_tokens: torch.Tensor,
               temps, seeds, rids, poss) -> np.ndarray:
    """(slots,) last tokens -> (slots,) next tokens on the host; the
    cache advances in place. Greedy slots share one argmax; sampled
    slots draw one by one."""
    logits, _ = model(last_tokens[:, None], cache=cache)
    rows = logits[:, 0].to(torch.float32)
    nxt = torch.argmax(rows, dim=-1).cpu().numpy()
    for slot in np.nonzero(temps > 0.0)[0]:
        nxt[slot] = _sample_token(rows[slot], float(temps[slot]),
                                  int(seeds[slot]), int(rids[slot]),
                                  int(poss[slot]))
    return nxt


ENV_KV_DTYPE = "HVD_TPU_SERVE_KV_DTYPE"   # fp32 | int8 cache storage
ENV_SLOTS = "HVD_TPU_SERVE_SLOTS"         # decode slots per replica
ENV_MAX_LEN = "HVD_TPU_SERVE_MAX_LEN"     # ring-buffer cache lines


def engine_defaults_from_env(env=None) -> Dict[str, Any]:
    """The env-tunable engine geometry: ``HVD_TPU_SERVE_KV_DTYPE`` /
    ``HVD_TPU_SERVE_SLOTS`` / ``HVD_TPU_SERVE_MAX_LEN``, as DecodeEngine
    kwargs."""
    env = env if env is not None else os.environ
    out: Dict[str, Any] = {}
    kind = env.get(ENV_KV_DTYPE)
    if kind:
        if kind not in kv_lib.KINDS:
            raise ValueError(
                f"{ENV_KV_DTYPE}={kind!r}: known kinds {kv_lib.KINDS}")
        out["kv_kind"] = kind
    for env_name, kwarg in ((ENV_SLOTS, "slots"),
                            (ENV_MAX_LEN, "max_len")):
        raw = env.get(env_name)
        if raw:
            try:
                out[kwarg] = int(raw)
            except ValueError:
                raise ValueError(
                    f"{env_name}={raw!r} must be an integer")
    return out


def make_engine_factory(model, params=None, device=None, parallel=None,
                        draft_model=None, draft_params=None,
                        spec_k: int = 0, prefix_cache=None,
                        **kw) -> Callable[[str], DecodeEngine]:
    """Factory the replica controller uses to start replicas: the same
    model (weights loaded once, moved to ``device`` once — default
    ``"cuda"``, raising without a GPU unless ``"cpu"`` is passed) and
    geometry, a fresh cache per replica. The serve levers thread
    through: every replica shares one ``parallel`` spec, one
    ``prefix_cache`` and one draft model (``draft_params`` loaded into
    it once, on the same device). The factory's ``tp_rank`` is this
    process's index on the spec's tp axis (0 without one): a tp
    replica's logs are written by its rank 0."""
    dev = resolve_device(device)
    spec = _tp_spec(parallel)
    if spec is not None:
        _check_tp(model, spec)
    if params is not None:
        model.load_state_dict(params)
    model = model.to(dev).eval()
    if draft_model is not None:
        if draft_params is not None:
            draft_model.load_state_dict(draft_params)
        draft_model = draft_model.to(dev).eval()

    def factory(name: str) -> DecodeEngine:
        return DecodeEngine(model, name=name, device=dev, parallel=spec,
                            prefix_cache=prefix_cache,
                            draft_model=draft_model, spec_k=spec_k, **kw)
    factory.tp_rank = tp_rank(spec)
    return factory

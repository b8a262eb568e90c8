"""One replica's decode plane: slots, prefill/decode, retire — the port
of ``horovod_tpu/serve/engine.py``.

Two programs serve every request mix, because request variety is data,
not shape (PyTorch runs them eagerly; there is no ``jit``):

* ``prefill`` — (1, max_prompt_len) tokens + a length: the prompt's KV
  lines land in a single-slot cache, the pad lines are then invalidated,
  and the first output token is sampled at position ``length - 1``.
  Admission copies the slot into the batch cache (``kvcache.write_slot``).
* ``decode`` — one token per slot across ALL slots: (slots, 1) last
  tokens against the (slots, max_len, ...) ring cache. Empty slots
  decode garbage that is never read.

Sampling: greedy argmax is the parity contract with the JAX package
(bit-identical token streams for the same weights and trace). With
``temperature > 0`` a token is drawn from ``softmax(logits / T)`` with a
``torch.Generator`` seeded from ``(seed, rid, position)`` alone — so it is
deterministic under re-batching and migration, but the draws differ
from the JAX package's ``jax.random`` lane: sampled parity is not
claimed.

Each decode round is bracketed with flight-recorder events (op
``serve``). Tensor-parallel decode, speculative decoding and the shared
prefix cache are later slices of the port and raise
``NotImplementedError``.
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

_LATER_SERVE_SLICE = "a later serve slice of the port"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; it comes with {_LATER_SERVE_SLICE}")


class DecodeEngine:
    """Slots + cache + prefill/decode for ONE replica.

    ``model`` is the port's GPT (``models/gpt.py``); ``params`` an
    optional state dict loaded into it (e.g. from
    ``models.convert.gpt_params_from_jax``). ``device`` defaults to
    ``"cuda"`` and raises without a GPU unless ``"cpu"`` is passed; the
    model is moved there. Greedy decode by default; ``eos_id`` (optional)
    ends a sequence early, ``max_new_tokens`` always bounds it."""

    def __init__(self, model, params=None, slots: int = 4,
                 max_len: int = 32, max_prompt_len: int = 16,
                 kv_kind: str = "fp32", eos_id: Optional[int] = None,
                 name: str = "r0", device=None, parallel=None,
                 prefix_cache=None, draft_model=None, draft_params=None,
                 spec_k: int = 0):
        if parallel is not None:
            raise _not_ported("tensor-parallel decode (parallel=)")
        if prefix_cache is not None:
            raise _not_ported("the shared-prefix KV cache (prefix_cache=)")
        if spec_k or draft_model is not None or draft_params is not None:
            raise _not_ported("speculative decoding (draft_model=/spec_k=)")
        if max_prompt_len > max_len:
            raise ValueError(
                f"max_prompt_len {max_prompt_len} exceeds the cache's "
                f"max_len {max_len}")
        from ..models.gpt import init_kv_cache

        self.device = resolve_device(device)
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
        # prefill. Only lines [0, max_prompt_len) are ever written, by
        # every prefill, so reuse leaves the same contents as the JAX
        # package's fresh all-zero template.
        self._single = init_kv_cache(model, 1, self.max_len,
                                     kind=kv_kind, device=self.device)
        _M_CACHE_BYTES.labels(replica=name).set(
            kv_lib.cache_nbytes(self.cache))
        self.requests: List[Optional[Request]] = [None] * self.slots
        self.generated: List[List[int]] = [[] for _ in range(self.slots)]
        self.last_tokens = np.zeros((self.slots,), np.int32)
        self.decode_steps = 0
        self.prefill_tokens = 0

    # -- admission -----------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is None]

    def active_count(self) -> int:
        return self.slots - len(self.free_slots())

    def admit(self, req: Request, now: float = 0.0) -> int:
        """Prefill ``req`` into a free slot; returns the slot. The prompt
        is truncated to the engine's ``max_prompt_len`` trailing
        window."""
        free = self.free_slots()
        if not free:
            raise RuntimeError(f"replica {self.name}: no free slot")
        slot = free[0]
        prompt = list(req.prompt)[-self.max_prompt_len:]
        padded = np.zeros((1, self.max_prompt_len), np.int64)
        padded[0, :len(prompt)] = prompt
        kv_lib.reset_slot(self._single, 0)
        single, first = _prefill_fn(
            self.model, torch.from_numpy(padded).to(self.device),
            len(prompt), self._single, req.temperature,
            req.sample_seed & 0x7FFFFFFF, req.rid)
        kv_lib.write_slot(self.cache, slot, single)
        self.requests[slot] = req
        req.replica = self.name
        req.first_token_t = now
        self.generated[slot] = [first]
        self.last_tokens[slot] = first
        self.prefill_tokens += len(prompt)
        _M_TOKENS.labels(kind="prompt").inc(len(prompt))
        _M_TOKENS.labels(kind="generated").inc()
        _M_ACTIVE.inc()
        tr = tracing.tracer()
        if tr.enabled:
            tr.prefill(req, self.name, now, len(prompt))
        return slot

    # -- the decode step -----------------------------------------------------

    def step(self, now: float = 0.0) -> List[Request]:
        """One decode round across every slot; retires and returns the
        requests that finished this step."""
        if self.active_count() == 0:
            return []
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
            next_np = _decode_fn(
                self.model, self.cache,
                torch.from_numpy(self.last_tokens.astype(np.int64)).to(
                    self.device), temps, seeds, rids, poss)
        except BaseException:
            rec.record_complete(step_name, outcome="error")
            raise
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
        self.requests[slot] = None
        self.generated[slot] = []
        kv_lib.reset_slot(self.cache, slot)
        _M_ACTIVE.dec()
        return req

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
            self.requests[slot] = None
            self.generated[slot] = []
            kv_lib.reset_slot(self.cache, slot)
            _M_ACTIVE.dec()
        return out

    def export_slot(self, slot: int) -> Dict[str, Any]:
        """A slot's warm cache as the int8 block-scaled wire blob
        (``kvcache.export_slot`` — kernel K2 on a GPU)."""
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
        self.requests[slot] = None
        self.generated[slot] = []
        kv_lib.reset_slot(self.cache, slot)
        _M_ACTIVE.dec()
        return req, blob, generated

    def admit_migrated(self, req: Request, blob: Dict[str, Any],
                       generated, now: float = 0.0) -> int:
        """Land a migrated sequence in a free slot: the wire blob imports
        into the cache (``kvcache.import_slot`` — kernel K4 on a GPU) and
        decode continues from the last generated token, no re-prefill."""
        free = self.free_slots()
        if not free:
            raise RuntimeError(f"replica {self.name}: no free slot")
        slot = free[0]
        stamp = blob.pop("trace", None) if isinstance(blob, dict) else None
        kv_lib.import_slot(self.cache, slot, blob)
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


def _prefill_fn(model, tokens: torch.Tensor, length: int,
                single_cache: Dict[str, Any], temp: float, seed: int,
                rid: int):
    """(1, P) padded prompt -> (single-slot cache, first output token).
    All P lines are written; the pad lines (positions >= base + length)
    are then invalidated and the write head rewinds to the true prompt
    end — the JAX engine's pad-then-invalidate semantics exactly."""
    base = single_cache["pos"].clone()                 # (1,) int32
    logits, cache = model(tokens, cache=single_cache)
    kv_lib.rewind_slots(cache, base + int(length))
    first = _sample_token(logits[0, length - 1], temp, seed, rid, 0)
    return cache, first


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
    geometry, a fresh cache per replica."""
    dev = resolve_device(device)
    if parallel is not None:
        raise _not_ported("tensor-parallel decode (parallel=)")
    if prefix_cache is not None:
        raise _not_ported("the shared-prefix KV cache (prefix_cache=)")
    if spec_k or draft_model is not None or draft_params is not None:
        raise _not_ported("speculative decoding (draft_model=/spec_k=)")
    if params is not None:
        model.load_state_dict(params)
    model = model.to(dev).eval()

    def factory(name: str) -> DecodeEngine:
        return DecodeEngine(model, name=name, device=dev, **kw)
    return factory

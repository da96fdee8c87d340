"""Batched serving engine: continuous-batching decode over prefilled caches
(port of ``repro.serving.engine``).

One fixed-capacity decode batch; requests occupy slots. Prefill computes a
prompt's cache (the model's collect-cache forward) and splices it into the
slot's rows of the batched decode cache; ``step`` advances every active slot
one token (greedy). Finished slots (EOS / max_len) free up for the queue.

The engine runs on the card unless given ``device="cpu"``; the model module
must live on that device. Where the reference ``jax.jit``\\ s the decode step,
the port runs it eagerly under ``torch.inference_mode()``; a Mamba prefill
launches K3 once a layer, a decode step launches none.

Kept as the reference has it:

* one ``cache_len`` for every slot, the longest slot's length: a slot with
  a shorter prompt gets its new K/V written at that position (a reference
  caveat, recorded in the README, ported as it is);
* greedy argmax over the padded vocabulary (first maximum on ties);
* the splice of a prefill cache into its slot, :func:`_splice`, shapes and
  clamping included.

With a ``collective_client`` (a :class:`repro_torch.service.ServiceClient`),
each step posts its batched slot-statistics reduction (active slots, tokens
emitted, finished requests) as an ALLREDUCE descriptor to the shared offload
service: the serving engine is one more tenant of the broker. The port's
descriptor is the planned form of the reference's (``axes=(1, batch_size)``,
``backend="pallas"``, ``chunks=1``), so the broker dispatches it through
K1, the fused collective kernel; the sum is the reference's. Tickets are
collected asynchronously; :meth:`ServeEngine.collect_service_stats`
resolves them into serving totals.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.trees import tree_map
from repro_torch.models import ModelApi
from repro_torch.models.model import model_device
from repro_torch.sharding.specs import Topology, use_topology


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,)
    max_new_tokens: int = 32
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _splice(big: torch.Tensor, small: torch.Tensor, slot: int) -> torch.Tensor:
    """The reference's splice of a batch-of-one prefill cache leaf into row
    ``slot`` of axis 1 of a decode cache leaf, as a new tensor.

    ``small`` is padded along axis 2 to ``big``'s size when they differ
    there (the KV sequence axis), then ``small[:, 0]`` is written at index
    ``slot`` of axis 1 with ``lax.dynamic_update_index_in_dim``'s rules: an
    update of one axis fewer gains that axis, and every start index clamps
    so the update fits. For the hybrid family's Mamba states, stacked
    (periods, sublayers, batch, ...), axis 1 is the sublayer axis, so the
    reference writes there too; the port does the same."""
    if big.ndim >= 3 and small.shape[2] != big.shape[2] and small.ndim == big.ndim:
        extra = big.shape[2] - small.shape[2]
        if extra < 0:
            raise ValueError(
                f"prefill cache {tuple(small.shape)} is longer than the decode "
                f"cache {tuple(big.shape)} along axis 2")
        pad = [0, 0] * (small.ndim - 3) + [0, extra]
        small = F.pad(small.to(big.dtype), pad)
    upd = small[:, 0].to(big.dtype)
    if upd.ndim != big.ndim:
        upd = upd.unsqueeze(1)
    starts = [0] * big.ndim
    starts[1] = slot
    index = tuple(
        slice(s, s + u)
        for s, u in ((min(max(s, 0), b - u), u)
                     for s, b, u in zip(starts, big.shape, upd.shape))
    )
    out = big.clone()
    out[index] = upd
    return out


class ServeEngine:
    def __init__(
        self,
        api: ModelApi,
        params: torch.nn.Module,
        topo: Topology,
        *,
        batch_size: int = 4,
        max_len: int = 256,
        eos_id: int = 1,
        collective_client=None,
        device: "torch.device | str | None" = None,
    ):
        self.api = api
        self.params = params
        self.topo = topo
        self.device = model_device(device)
        held = {t.device for t in params.parameters()}
        if held != {self.device}:
            raise ValueError(
                f"the model lives on {sorted(map(str, held))}, the engine on "
                f"{self.device}; move one of them explicitly")
        self.B = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        with use_topology(topo):
            self.cache = api.init_cache(batch_size, max_len, device=self.device)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.lengths = np.zeros(batch_size, dtype=np.int32)
        self.cur_tokens = np.zeros((batch_size, 1), dtype=np.int32)
        self.queue: List[Request] = []
        # offload-service tenancy: the per-step slot-stats reduction is a
        # wire-encoded ALLREDUCE over the slot axis (each slot plays the
        # role of a rank), submitted async and resolved on demand
        self._collective = collective_client
        self._stat_tickets: List = []
        self._stat_totals = np.zeros(3, dtype=np.float64)
        self._stat_steps = 0
        self._stats_desc = (
            None
            if collective_client is None
            else collective_client.broker.make_descriptor(
                "ALLREDUCE", axes=(1, batch_size), payload_bytes=3 * 4,
                op="sum", backend="pallas", chunks=1,
            ).encode()
        )

    # -------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.B):
            if self.slots[slot] is None and self.queue:
                req = self.queue.pop(0)
                self._prefill_into(slot, req)
                self.slots[slot] = req

    def _prefill_into(self, slot: int, req: Request) -> None:
        """Run prompt prefill batch-of-1 and splice cache rows into the slot."""
        plen = len(req.prompt)
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)[None, :]
        with use_topology(self.topo), torch.inference_mode():
            last_logits, pcache = self.api.prefill(
                self.params, {"tokens": tokens}
            )
            self.cache = tree_map(lambda big, small: _splice(big, small, slot),
                                  self.cache, pcache)
            first = int(torch.argmax(last_logits[:, -1], -1)[0])
        self.cur_tokens[slot, 0] = first
        self.lengths[slot] = plen
        req.generated.append(first)

    # ---------------------------------------------------------------- step
    def step(self) -> Dict[int, int]:
        """Advance every active slot one token. Returns {rid: token}."""
        self._admit()
        active = [s for s in range(self.B) if self.slots[s] is not None]
        if not active:
            return {}
        # one shared cache_len per step: use the max; per-slot correctness
        # comes from each slot's own written region (padding regions score
        # ~0 after the causal mask)
        clen = int(self.lengths.max())
        with use_topology(self.topo), torch.inference_mode():
            nxt, self.cache = self.api.decode_step(
                self.params,
                torch.as_tensor(self.cur_tokens, device=self.device),
                self.cache,
                clen,
            )
            nxt = nxt.cpu().numpy()
        out: Dict[int, int] = {}
        for s in active:
            req = self.slots[s]
            tok = int(nxt[s, 0])
            req.generated.append(tok)
            out[req.rid] = tok
            self.lengths[s] += 1
            if (
                tok == self.eos_id
                or len(req.generated) >= req.max_new_tokens
                or self.lengths[s] >= self.max_len - 1
            ):
                req.done = True
                self.slots[s] = None
            else:
                self.cur_tokens[s, 0] = tok
        if self._collective is not None:
            self._post_step_stats(active)
        return out

    # ------------------------------------------------- service tenancy
    def _post_step_stats(self, active) -> None:
        """Post this step's batched slot-stats reduction to the offload
        service: per-slot [active, tokens_emitted, finished] rows, summed
        over the slot axis by one shared ALLREDUCE dispatch."""
        stats = np.zeros((self.B, 3), dtype=np.float32)
        for s in active:
            stats[s, 0] = 1.0  # slot was active
            stats[s, 1] = 1.0  # one token emitted per active slot per step
            if self.slots[s] is None:  # freed this step => request finished
                stats[s, 2] = 1.0
        payload = torch.from_numpy(stats).to(self._collective.broker.engine.device)
        self._stat_tickets.append(
            self._collective.submit(self._stats_desc, payload)
        )
        # fold already-completed tickets into the running totals so a
        # long-lived serving process never accumulates unbounded tickets
        still_pending = []
        for ticket in self._stat_tickets:
            if ticket.done():
                self._fold_ticket(ticket, timeout=0.0)
            else:
                still_pending.append(ticket)
        self._stat_tickets = still_pending

    def _fold_ticket(self, ticket, timeout: float) -> None:
        reduced = ticket.result(timeout).cpu().numpy()
        self._stat_totals += reduced[0]  # every row holds the slot-axis sum
        self._stat_steps += 1

    def collect_service_stats(self, timeout: float = 30.0) -> Dict[str, int]:
        """Resolve outstanding stat tickets and return the serving totals
        accumulated since the last call."""
        for ticket in self._stat_tickets:
            self._fold_ticket(ticket, timeout)
        self._stat_tickets = []
        out = {
            "service_steps": self._stat_steps,
            "slot_steps": int(self._stat_totals[0]),
            "tokens_emitted": int(self._stat_totals[1]),
            "requests_finished": int(self._stat_totals[2]),
        }
        self._stat_totals = np.zeros(3, dtype=np.float64)
        self._stat_steps = 0
        return out

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                return
            self.step()

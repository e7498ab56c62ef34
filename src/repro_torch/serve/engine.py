"""Batched serving engine: prefill + decode over a shared cache (KV rows,
MLA's latent rows or SSM state, whatever the model's ``init_cache`` holds).

The engine keeps a fixed-capacity batch of request slots (continuous
batching: finished requests free their slot for the next queued request).
``step`` decodes one token for every live slot.  The admission queue groups
requests by shared prompt prefix before slot assignment, so requests of one
group land in adjacent slots and their KV rows sit in adjacent cache rows.

Behaviour follows the JAX package's ``repro.serve.engine`` step for step,
two faults of the reference included (ROADMAP queue 3): ``_prefill`` feeds
the prompt one token at a time through a decode call over the whole slot
batch, so it writes the prefilling token's k/v (and, for Mamba2, advances
the SSM and conv state) in every slot, live ones included; and ``step``
decodes every slot at ``max(pos)``.  With MoE every slot of a step routes
in one group, so the slots share the experts' capacity, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.lm import LM


@dataclasses.dataclass
class Request:
    """One LM generation request: a prompt and a new-token budget.

    Example::

        eng.run([Request(rid=0, prompt=np.array([1, 2, 3], np.int32),
                         max_new=8)])
    """

    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int = 16
    out: Optional[List[int]] = None


def _prefix_group_order(requests: List[Request], depth: int = 8) -> List[Request]:
    """Sort the admission queue by prompt prefix (locality grouping)."""
    return sorted(requests, key=lambda r: tuple(r.prompt[:depth].tolist()))


class ServeEngine:
    """Continuous-batching LM decode over a fixed-capacity slot batch, on
    the model's device.

    Example::

        eng = ServeEngine(model, params, batch_slots=2, max_len=64)
        done = eng.run(requests)      # {rid: [generated token ids]}
    """

    def __init__(self, model: LM, params, batch_slots: int, max_len: int,
                 group_prefixes: bool = True):
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.group_prefixes = group_prefixes
        self.cache = model.init_cache(batch_slots, max_len)
        self.pos = np.zeros(batch_slots, np.int32)
        self.live: List[Optional[Request]] = [None] * batch_slots

    def _decode(self, tokens: np.ndarray, cache_pos: int) -> torch.Tensor:
        tok = torch.from_numpy(tokens).to(self.model.device)
        logits, self.cache, _ = self.model.forward(
            self.params, tokens=tok, cache=self.cache, cache_pos=cache_pos)
        return logits

    # ----------------------------------------------------------- admission -
    def admit(self, requests: List[Request]) -> List[Request]:
        """Fill free slots; returns the requests actually admitted."""
        if self.group_prefixes:
            requests = _prefix_group_order(requests)
        admitted = []
        qi = 0
        for s in range(self.slots):
            if self.live[s] is None and qi < len(requests):
                r = requests[qi]
                qi += 1
                r.out = []
                self.live[s] = r
                self._prefill(s, r)
                admitted.append(r)
        return admitted

    def _prefill(self, slot: int, r: Request):
        # single-slot prefill through the decode path, one token at a time
        # (block prefill is LM.forward without a cache, the K4 / K5 path)
        for i, t in enumerate(r.prompt.tolist()):
            tok = np.zeros((self.slots, 1), np.int32)
            tok[slot, 0] = t
            self._decode(tok, i)
        self.pos[slot] = len(r.prompt)

    # -------------------------------------------------------------- decode -
    def step(self, greedy: bool = True) -> Dict[int, int]:
        """One decode step for every live slot; returns ``{rid: token}``."""
        toks = np.zeros((self.slots, 1), np.int32)
        for s, r in enumerate(self.live):
            if r is not None and r.out:
                toks[s, 0] = r.out[-1]
            elif r is not None and len(r.prompt):
                toks[s, 0] = int(r.prompt[-1])
        cpos = int(self.pos.max()) if self.pos.max() else 0
        logits = self._decode(toks, cpos)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        out = {}
        for s, r in enumerate(self.live):
            if r is None:
                continue
            t = int(nxt[s])
            r.out.append(t)
            out[r.rid] = t
            self.pos[s] += 1
            if len(r.out) >= r.max_new or self.pos[s] >= self.max_len - 1:
                self.live[s] = None  # free the slot (continuous batching)
        return out

    def run(self, requests: List[Request], max_steps: int = 64) -> Dict[int, List[int]]:
        """Admit + decode until every request finishes (or ``max_steps``);
        returns ``{rid: generated tokens}`` (e.g. ``run(reqs)[0]``)."""
        queue = list(requests)
        done: Dict[int, List[int]] = {}
        steps = 0
        while (queue or any(self.live)) and steps < max_steps:
            admitted = self.admit(queue)
            queue = [r for r in queue if r not in admitted]
            self.step()
            for r in list(requests):
                if (
                    r.out is not None
                    and r not in queue
                    and all(self.live[s] is not r for s in range(self.slots))
                ):
                    done[r.rid] = r.out
            steps += 1
        return done

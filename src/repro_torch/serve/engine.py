"""Batched serving engine with continuous batching (slot-based).

Port of ``repro/serve/engine.py``.  A fixed pool of B decode slots shares
stacked KV caches; new requests are prefilled into free slots while other
slots keep decoding (one engine step = the prefills of the free slots, then
one batched decode).  Retired slots return their tokens.  This is the serving
counterpart of the paper's online mode: the request router (GeoGraphStore)
picks the serving site; this engine is what runs inside each site.

On the card, every prefill runs the flash-attention kernel in each layer
(MLA, or GQA with the layer's window); decode attends in plain PyTorch
with per-slot valid lengths.  The caches live on the engine's device and
are updated in place: an admitted request's prefilled cache is written
into its slot along the sequence axis (``-2`` in both layouts: MLA
``[L, B, S, r]``, GQA ``[L, B, Hkv, S, hd]``), with every position past its
prompt zeroed, and each decode step writes one position per slot.  Free
slots still decode token 0 at their position, as in the JAX package;
greedy sampling takes the first maximum.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import transformer as tf

__all__ = ["Engine", "Request", "ServeConfig"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [len] token ids
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeConfig:
    n_slots: int = 4
    max_len: int = 128
    eos_id: int = -1  # -1: never stop early
    greedy: bool = True


class Engine:
    def __init__(
        self, params: tf.Params, cfg: tf.LMConfig, scfg: ServeConfig,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.slots: List[Optional[Request]] = [None] * scfg.n_slots
        self.pos = np.zeros(scfg.n_slots, dtype=np.int32)
        self.budget = np.zeros(scfg.n_slots, dtype=np.int32)
        self.caches = self._empty_caches()
        self.queue: List[Request] = []

    def _empty_caches(self) -> Dict[str, torch.Tensor]:
        c = self.cfg
        b, s = self.scfg.n_slots, self.scfg.max_len
        if c.mla:
            shapes = {"c_kv": (c.n_layers, b, s, c.kv_lora_rank),
                      "k_rope": (c.n_layers, b, s, c.qk_rope_dim)}
        else:
            shapes = {key: (c.n_layers, b, c.n_kv_heads, s, c.hd) for key in ("k", "v")}
        return {key: torch.zeros(shape, dtype=c.dtype, device=self.device)
                for key, shape in shapes.items()}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # ------------------------------------------------------------------ step
    @torch.inference_mode()
    def step(self) -> List[Request]:
        """One engine iteration; returns requests completed this step."""
        self._admit()
        finished: List[Request] = []
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if active:
            tokens = np.zeros(self.scfg.n_slots, dtype=np.int64)
            for i in active:
                r = self.slots[i]
                tokens[i] = r.out_tokens[-1] if r.out_tokens else int(r.prompt[-1])
            logits, self.caches = tf.decode(
                self.params,
                torch.as_tensor(tokens, device=self.device),
                self.caches,
                torch.as_tensor(self.pos, dtype=torch.int64, device=self.device),
                self.cfg,
            )
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for i in active:
                r = self.slots[i]
                tok = int(nxt[i])
                r.out_tokens.append(tok)
                self.pos[i] += 1
                self.budget[i] -= 1
                if (
                    self.budget[i] <= 0
                    or tok == self.scfg.eos_id
                    or self.pos[i] >= self.scfg.max_len - 1
                ):
                    r.done = True
                    finished.append(r)
                    self.slots[i] = None
        return finished

    def _admit(self) -> None:
        """Prefill queued requests into free slots (one per step per slot)."""
        for i in range(self.scfg.n_slots):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            plen = len(req.prompt)
            if not 0 < plen <= self.scfg.max_len:
                raise ValueError(f"prompt of {plen} tokens for max_len {self.scfg.max_len}")
            prompt = torch.as_tensor(np.asarray(req.prompt, dtype=np.int64), device=self.device)
            _, pc = tf.prefill(self.params, prompt[None], self.cfg)
            for key, c_all in self.caches.items():
                c_all[:, i, ..., :plen, :] = pc[key][:, 0]
                c_all[:, i, ..., plen:, :] = 0
            self.slots[i] = req
            self.pos[i] = plen
            self.budget[i] = req.max_new_tokens

    def run_to_completion(self, max_steps: int = 1000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            done.extend(self.step())
            if not self.queue and all(s is None for s in self.slots):
                break
        return done

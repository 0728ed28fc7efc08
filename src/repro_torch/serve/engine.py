"""Serving engine: prefill + lockstep decode over the LM (the reference's
``repro/serve/engine.py``).

Prompt lengths are bucketed to powers of two from 16, as the reference
buckets them to bound its compiles; the port keeps the buckets so both
see the same padded batch (and so the same tokens).  Prompts are
right-aligned and left-padded with ``pad_id``; as in the reference, the
pad tokens are not masked, so a short prompt's first real token attends
to the pads before it.

Two departures from the reference, neither changing a greedy token:
prefill keeps only the last position's logits (``last_only``; the
reference computes all of them and reads the last), and the decode
cache (the block pattern's KV buffers and recurrent states, which
``generate`` passes through untouched) is updated in place.  Sampling (``temperature > 0``) draws from a
``torch.Generator`` seeded with ``seed``; it cannot give
``jax.random``'s draws.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: transformer.LM, *,
                 max_len: int = 512, pad_id: int = 0, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, but "
                             f"device={self.device}")
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.pad_id = pad_id

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(self, prompts: list[list[int]], max_new_tokens: int,
                 *, temperature: float = 0.0, seed: int = 0
                 ) -> list[list[int]]:
        """Batched greedy (or temperature-sampled) generation.

        The whole batch prefills at the bucketed longest prompt length
        (left-padded) and decodes in lockstep from that position; each
        step's tokens come to the host once.  Returns each prompt followed
        by its ``max_new_tokens`` new tokens.  A model with embedding
        inputs (``input_mode="embeddings"``) has no tokens to feed back,
        so it raises ``ValueError``: drive it through
        ``transformer.prefill`` and ``decode_step``.
        """
        cfg = self.cfg
        if cfg.input_mode != "tokens":
            raise ValueError(
                f"{cfg.name}: generate feeds tokens back, but the model "
                f"takes input_mode={cfg.input_mode!r}; call "
                f"transformer.prefill and decode_step with embeddings")
        b = len(prompts)
        lens = np.array([len(p) for p in prompts])
        s = _bucket(int(lens.max()))
        toks = np.full((b, s), self.pad_id, np.int64)
        for i, p in enumerate(prompts):        # right-aligned ⇒ uniform pos
            toks[i, s - len(p):] = p
        logits, cache = transformer.prefill(
            cfg, self.model, {"tokens": torch.from_numpy(toks)},
            max_len=s + max_new_tokens, last_only=True)
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        out = [list(p) for p in prompts]
        last = logits[:, -1]                   # (B, V)
        for t in range(max_new_tokens):
            if temperature > 0:
                probs = torch.softmax(last / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = torch.argmax(last, dim=-1)
            for i, tok in enumerate(nxt.tolist()):
                out[i].append(tok)
            last, cache = transformer.decode_step(cfg, self.model, cache,
                                                  nxt, s + t)
        return out


__all__ = ["ServeEngine"]

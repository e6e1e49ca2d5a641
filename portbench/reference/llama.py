"""The plain reference: a Llama-architecture decoder in float32, in plain
PyTorch, over the benchmark's own seeded weights.

It imports nothing of the program. It takes the weights as the benchmark
made them (int8 payloads ``[L, N, K]`` with f32 per-output-channel scales,
a bf16 embedding, bf16 norm weights) and computes, from the token ids alone,
the logits at the positions where a served token was chosen. It works out
again everything the program derives: the per-row int8 quantization of
each projection's input (the configuration's w8a8), the int8 (token, head)
quantization of every key and value (the configuration's int8 KV cache),
RoPE at each token's global position, causal attention over one sequence
(prefix then continuation), the MLP, the norms and the LM head (weight-only
int8, as the configuration serves it). Matrix products run in float32 with
TF32 off.

``w_bits=4, kv_bits=4`` gives the control: the same model one precision
step down (each projection's weight requantized to int4 in groups of 128
along its input, the keys and values to int4 a (token, head)), the step a
later change would be tempted to take.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

FAMILIES = ("wq", "wk", "wv", "wo", "gate", "up", "down")
GROUP4 = 128


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quant_rows(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-row int8 quantization of ``x [n, K]``, returned
    dequantized: scale = amax times the f32 reciprocal of 127."""
    recip = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-20) * recip
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def quant_kv(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-(token, head) quantization of ``x [..., hd]`` (amax over
    the head dimension), returned dequantized."""
    top = 127.0 if bits == 8 else 7.0
    recip = torch.tensor(1.0 / top, dtype=torch.float32, device=x.device)
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) * recip
    return torch.clamp(torch.round(x / scale), -top, top) * scale


def weight(q: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """A projection's float32 weight ``[N, K]`` from its int8 payload and f32
    per-output-channel scale; ``bits=4`` requantizes it to int4 in groups of
    ``GROUP4`` along K (symmetric, amax / 7)."""
    w = q.float() * scale.float()[:, None]
    if bits == 8:
        return w
    N, K = w.shape
    g = math.gcd(K, GROUP4)
    wg = w.reshape(N, K // g, g)
    gs = torch.clamp(wg.abs().amax(dim=-1, keepdim=True), min=1e-8) / 7.0
    return (torch.clamp(torch.round(wg / gs), -7, 7) * gs).reshape(N, K)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [n, heads, hd]`` rotated at positions ``pos [n]`` (rotate-half
    convention; angles in float64, then float32)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = pos.double()[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1).float()[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1).float()[:, None, :]
    rot = torch.cat([-x[..., hd // 2:], x[..., : hd // 2]], dim=-1)
    return x * cos + rot * sin


class Reference:
    """The reference model over a weight dict (see the module docstring)."""

    def __init__(self, weights: dict, cfg: dict, w_bits: int = 8, kv_bits: int = 8,
                 score_bytes: int = 1 << 30):
        _no_tf32()
        self.w = weights
        self.H = int(cfg["hidden_size"])
        self.nh = int(cfg["num_attention_heads"])
        self.nkv = int(cfg["num_key_value_heads"])
        self.L = int(cfg["num_hidden_layers"])
        self.hd = self.H // self.nh
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.w_bits, self.kv_bits = w_bits, kv_bits
        self.score_bytes = score_bytes  # the largest score block held at once

    def _proj(self, x: torch.Tensor, w: torch.Tensor, rows: int = 4096) -> torch.Tensor:
        """w8a8: each row of ``x`` quantized to int8, times the weight."""
        out = []
        for i in range(0, x.shape[0], rows):
            out.append(quant_rows(x[i:i + rows]) @ w.T)
        return torch.cat(out)

    def _attend(self, q, raw, kv, n_before: int, seg: int) -> torch.Tensor:
        """Causal attention of ``q [n, nh, hd]`` (the last ``n`` tokens of the
        sequence) over the keys and values of all ``n_before + n`` tokens,
        ``raw`` as computed and ``kv`` as the cache stores them (pairs of
        ``[n_before + n, nkv, hd]``). Query ``i`` sees keys ``[0, n_before +
        i]``, reading those of its own forward as computed and the rest as
        stored: its forward is the first ``seg`` tokens (a prefill) for
        ``i < seg``, else itself alone (a decode step)."""
        n, S = q.shape[0], kv[0].shape[0]
        g = self.nh // self.nkv
        dev = q.device
        block = max(1, min(n, self.score_bytes // (8 * self.nh * max(S, 1))))
        out = torch.empty((n, self.nh, self.hd), dtype=torch.float32, device=dev)
        scale = 1.0 / math.sqrt(self.hd)
        all_raw = n_before == 0 and seg >= n

        def scores(k, qb, hi):
            return torch.matmul(qb, k[:hi].permute(1, 2, 0).unsqueeze(1)) * scale

        def mix(p, v, hi):
            return torch.matmul(p, v[:hi].permute(1, 0, 2).unsqueeze(1))

        for a in range(0, n, block):
            b = min(n, a + block)
            hi = n_before + b  # keys any query of the block may see
            qb = q[a:b].reshape(b - a, self.nkv, g, self.hd).permute(1, 2, 0, 3)
            i = torch.arange(a, b, device=dev)[:, None]
            j = torch.arange(hi, device=dev)[None, :] - n_before
            own = (j <= i) & (j >= torch.where(i < seg, 0, i))  # read as computed
            s_raw = scores(raw[0], qb, hi)
            s = s_raw if all_raw else torch.where(own, s_raw, scores(kv[0], qb, hi))
            p = torch.softmax(s.masked_fill(j > i, float("-inf")), dim=-1)
            if all_raw:
                o = mix(p, raw[1], hi)
            else:
                o = mix(p * own, raw[1], hi) + mix(p * ~own, kv[1], hi)
            out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, self.nh, self.hd)
        return out

    def _layer(self, li: int, x: torch.Tensor, pos: torch.Tensor, seg: int, past=None):
        """One decoder layer over ``x [n, H]`` at positions ``pos`` (the first
        ``seg`` rows one prefill, the rest decode steps); ``past`` is the
        keys and values of the tokens before, as the cache stores them.
        Returns the new hidden rows and this layer's keys and values of
        ``x`` as the cache stores them."""
        w = self.w
        W = {f: weight(w[f][0][li], w[f][1][li], self.w_bits) for f in FAMILIES}
        n = x.shape[0]
        h = rms_norm(x, w["input_norm"][li], self.eps)
        q = rope(self._proj(h, W["wq"]).reshape(n, self.nh, self.hd), pos, self.theta)
        k = rope(self._proj(h, W["wk"]).reshape(n, self.nkv, self.hd), pos, self.theta)
        v = self._proj(h, W["wv"]).reshape(n, self.nkv, self.hd)
        if self.kv_bits is None:  # keys and values stored in float32
            kq, vq = k, v
        else:
            kq, vq = quant_kv(k, self.kv_bits), quant_kv(v, self.kv_bits)
        raw, kv = (k, v), (kq, vq)
        if past is not None:
            pad = lambda t: torch.cat([torch.zeros_like(past[0]), t])  # noqa: E731
            raw = (pad(k), pad(v))  # the tokens before are never read as computed
            kv = (torch.cat([past[0], kq]), torch.cat([past[1], vq]))
        attn = self._attend(q, raw, kv, kv[0].shape[0] - n, seg).reshape(n, self.H)
        x = x + self._proj(attn, W["wo"])
        h = rms_norm(x, w["post_attn_norm"][li], self.eps)
        rows = 4096
        for i in range(0, n, rows):
            hi = h[i:i + rows]
            gu = torch.nn.functional.silu(self._proj(hi, W["gate"])) * self._proj(hi, W["up"])
            x[i:i + rows] += self._proj(gu, W["down"])
        return x, (kq, vq)

    @torch.no_grad()
    def served_logits(self, prefix: torch.Tensor, conts: Sequence[torch.Tensor],
                      n_pred: Sequence[int]) -> List[torch.Tensor]:
        """The logits ``[n_pred[i], V]`` at the last ``n_pred[i]`` positions
        of each sequence ``prefix + conts[i]`` (int64 ids on one device),
        computed layer by layer: the prefix once, each continuation over
        its keys and values."""
        w, P = self.w, int(prefix.shape[0])
        emb = w["embed"]
        x0 = emb[prefix.long()].float()
        xs = [emb[c.long()].float() for c in conts]
        p0 = torch.arange(P, device=prefix.device)
        ps = [P + torch.arange(c.shape[0], device=prefix.device) for c in conts]
        # A continuation is its prompt's prefill, then one decode step a token.
        segs = [c.shape[0] - n + 1 for c, n in zip(conts, n_pred)]
        for li in range(self.L):
            x0, kv0 = self._layer(li, x0, p0, P)
            xs = [self._layer(li, x, p, sg, kv0)[0] for x, p, sg in zip(xs, ps, segs)]
        head = w["lm_head"][0].float() * w["lm_head"][1].float()[:, None]
        out = []
        for x, n in zip(xs, n_pred):
            h = rms_norm(x[x.shape[0] - n:], w["final_norm"], self.eps)
            out.append(h @ head.T)
        return out

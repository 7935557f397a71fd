"""Recurrent sequence mixers (twin of ``repro.models.ssm``): mLSTM and sLSTM
(xLSTM) and the Mamba-style selective scan (Hymba).

Every cell has a full-sequence form and a one-token step with carried
state, with the reference's signatures and state tuples:

* mLSTM: ``mlstm_sequential`` (the step-by-step form, also the decode path)
  and ``mlstm_chunkwise`` (chunks of ``MLSTM_CHUNK`` rows: masked
  gate-decayed attention inside a chunk, the carried matrix memory across
  chunks), state ``(C (B,H,D,D), n (B,H,D), m (B,H))``;
* sLSTM: ``slstm_parallel``, state ``(c, n, m, h)`` of (B, H, Dh).  The
  recurrence is sequential; the reference runs it as a double scan over
  ``SLSTM_CHUNK``-row slabs (an XLA loop-traffic device), the port as a
  plain loop over steps, with the same result;
* Mamba: ``mamba_scan``, the linear recurrence h_t = a_t * h_{t-1} + b_t in
  chunks of ``MAMBA_CHUNK`` rows.  The reference runs
  ``jax.lax.associative_scan`` inside a chunk; the port a doubling
  (Hillis–Steele) scan, log2(chunk) passes over the chunk, and a loop over
  chunks.  A token-by-token loop would be ~400 k launches at S 4096 over
  hymba's 32 layers; a cumulative product divided out would underflow
  (a = exp(Δ·A), A < 0, over 256 rows);
* ``causal_conv1d``: the depthwise causal convolution with its (B, K-1, Di)
  tail of earlier inputs.

All recurrences run in float32, whatever the inputs' dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

MLSTM_CHUNK = 64
MAMBA_CHUNK = 256
SLSTM_CHUNK = 64    # the reference's slab; the port's loop has none


# ===========================================================================
# mLSTM — matrix-memory LSTM, stabilised exponential gating
# ===========================================================================
def mlstm_zero_state(B: int, H: int, D: int, device) -> Tuple[torch.Tensor,
                                                              ...]:
    """(C, n, m): zero memories, stabilisers at -inf."""
    f32 = torch.float32
    return (torch.zeros((B, H, D, D), dtype=f32, device=device),
            torch.zeros((B, H, D), dtype=f32, device=device),
            torch.full((B, H), -math.inf, dtype=f32, device=device))


def mlstm_sequential(q, k, v, i_pre, f_pre, state=None):
    """Step-by-step mLSTM (the oracle and the decode path).

    q, k, v: (B, S, H, D); i_pre, f_pre: (B, S, H) gate pre-activations;
    state: (C, n, m) or None.  Returns h (B, S, H, D) in q's dtype and the
    new state."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    if state is None:
        state = mlstm_zero_state(B, H, D, q.device)
    C, n, m = state
    hs = []
    for t in range(S):
        qt = q[:, t].float()
        kt = k[:, t].float() * scale
        vt = v[:, t].float()
        lf = F.logsigmoid(f_pre[:, t].float())
        li = i_pre[:, t].float()
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * \
            torch.einsum("bhd,bhe->bhde", kt, vt)
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhde,bhd->bhe", C, qt)
        den = torch.einsum("bhd,bhd->bh", n, qt).abs()
        den = torch.maximum(den, torch.exp(-m_new))[..., None]
        hs.append(num / den)
        m = m_new
    return torch.stack(hs, 1).to(q.dtype), (C, n, m)


def mlstm_chunkwise(q, k, v, i_pre, f_pre, state=None,
                    chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel mLSTM: O(S·L) attention inside a chunk of L rows,
    the state carried across chunks; equals ``mlstm_sequential``.  S must
    be a multiple of ``min(chunk, S)`` (the block pads, as the
    reference's)."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    L = min(chunk, S)
    assert S % L == 0, (S, L)
    if state is None:
        state = mlstm_zero_state(B, H, D, q.device)
    C, n, m = state
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    hs = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        qc, kc, vc = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        lf = F.logsigmoid(f_pre[:, sl].float())             # (B, L, H)
        li = i_pre[:, sl].float()
        b = torch.cumsum(lf, dim=1)                         # inclusive
        b_total = b[:, -1]                                  # (B, H)
        # log weight of k_s surviving to the chunk's end
        w_end = li + b_total[:, None] - b                   # (B, L, H)
        m_next = torch.maximum(b_total + m, w_end.amax(dim=1))
        # inside the chunk: q_t·k_s · exp(b_t - b_s + li_s - m_comb_t), s <= t
        qk = torch.einsum("blhd,bshd->bhls", qc * scale, kc)
        bt, lt = b.transpose(1, 2), li.transpose(1, 2)      # (B, H, L)
        logw = bt[..., :, None] - bt[..., None, :] + lt[..., None, :]
        logw = logw.masked_fill(~mask, -math.inf)
        m_inter = bt + m[..., None]                         # (B, H, L)
        m_comb = torch.maximum(logw.amax(dim=-1), m_inter)
        dmat = torch.exp(logw - m_comb[..., None]).masked_fill(~mask, 0.0)
        s_w = qk * dmat
        num_intra = torch.einsum("bhls,bshd->blhd", s_w, vc)
        den_intra = s_w.sum(dim=-1).transpose(1, 2)         # (B, L, H)
        # across chunks: the carried state
        wq = torch.exp(m_inter - m_comb).transpose(1, 2)    # (B, L, H)
        qw = qc * wq[..., None]
        num = num_intra + torch.einsum("blhd,bhde->blhe", qw, C)
        den = (den_intra + torch.einsum("blhd,bhd->blh", qw, n)).abs()
        den = torch.maximum(den, torch.exp(-m_comb.transpose(1, 2)))
        hs.append(num / den[..., None])
        # the state at the chunk's end
        k_w = kc * scale * torch.exp(w_end - m_next[:, None])[..., None]
        decay = torch.exp(b_total + m - m_next)
        C = decay[..., None, None] * C + \
            torch.einsum("blhd,blhe->bhde", k_w, vc)
        n = decay[..., None] * n + k_w.sum(dim=1)
        m = m_next
    return torch.cat(hs, 1).to(q.dtype), (C, n, m)


def mlstm_step(q, k, v, i_pre, f_pre, state):
    """One decode step: q, k, v (B, 1, H, D); gates (B, 1, H)."""
    return mlstm_sequential(q, k, v, i_pre, f_pre, state)


# ===========================================================================
# sLSTM — scalar-memory LSTM with recurrent gating (sequential)
# ===========================================================================
def slstm_parallel(x_gates: torch.Tensor, r_weights: Dict[str, torch.Tensor],
                   state=None, chunk: int = SLSTM_CHUNK):
    """x_gates: (B, S, H, Dh, 4) input pre-activations of (z, i, f, o);
    ``r_weights["z"|"i"|"f"|"o"]``: (H, Dh, Dh) block-diagonal recurrent
    weights.  Returns h (B, S, H, Dh) in x_gates' dtype and the state
    (c, n, m, h).  ``chunk`` is the reference's slab and changes nothing
    here (module docstring)."""
    B, S, H, Dh, _ = x_gates.shape
    if state is None:
        z0 = torch.zeros((B, H, Dh), dtype=torch.float32,
                         device=x_gates.device)
        state = (z0, z0, torch.full_like(z0, -math.inf), z0)
    r_all = torch.stack([r_weights[g] for g in ("z", "i", "f", "o")],
                        dim=-1).float()                     # (H, Dh, Dh, 4)
    c, n, m, h = state
    hs = []
    for t in range(S):
        pre = x_gates[:, t].float() + \
            torch.einsum("bhd,hdef->bhef", h, r_all)        # (B, H, Dh, 4)
        z = torch.tanh(pre[..., 0])
        i_t, f_t = pre[..., 1], pre[..., 2]
        o = torch.sigmoid(pre[..., 3])
        lf = F.logsigmoid(f_t)
        m_new = torch.maximum(lf + m, i_t)
        ip = torch.exp(i_t - m_new)
        fp = torch.exp(lf + m - m_new)
        c = fp * c + ip * z
        n = fp * n + ip
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1).to(x_gates.dtype), (c, n, m, h)


def slstm_step(x_gates, r_weights, state):
    return slstm_parallel(x_gates, r_weights, state)


# ===========================================================================
# Mamba-style selective SSM (Hymba's SSM heads)
# ===========================================================================
def doubling_scan(a: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the affine maps h -> a_t·h + b_t along axis 1 by
    doubling: after the pass of offset o each row holds the composition of
    the 2·o rows ending at it.  Returns (A_t, B_t) with h_t = A_t·h_0 + B_t."""
    L = a.shape[1]
    off = 1
    while off < L:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, b


def mamba_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None, chunk: int = MAMBA_CHUNK):
    """Linear recurrence h_t = a_t · h_{t-1} + b_t, chunk by chunk.

    a, b: (B, S, Di, N); S a multiple of ``min(chunk, S)``.  Returns h
    (B, S, Di, N) and h_last (B, Di, N), float32."""
    B, S, Di, N = a.shape
    L = min(chunk, S)
    assert S % L == 0, (S, L)
    h = (torch.zeros((B, Di, N), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    hs = []
    for c0 in range(0, S, L):
        aa, bb = doubling_scan(a[:, c0:c0 + L].float(),
                               b[:, c0:c0 + L].float())
        hc = aa * h[:, None] + bb
        h = hc[:, -1]
        hs.append(hc)
    return torch.cat(hs, 1), h


def mamba_step(a_t, b_t, h):
    """One decode step: a_t, b_t, h (B, Di, N)."""
    h_new = a_t * h + b_t
    return h_new, h_new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution.  x: (B, S, Di); w: (K, Di); b: (Di,);
    conv_state: (B, K-1, Di), the inputs before x (zeros when None).
    Returns y (B, S, Di) in x's dtype (accumulated in float32) and the new
    state, the last K-1 inputs."""
    B, S, Di = x.shape
    K = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, Di), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)    # (B, S+K-1, Di)
    y = torch.zeros((B, S, Di), dtype=torch.float32, device=x.device)
    for j in range(K):
        y = y + xp[:, j:j + S].float() * w[j].float()
    y = (y + b.float()).to(x.dtype)
    return y, xp[:, S:]

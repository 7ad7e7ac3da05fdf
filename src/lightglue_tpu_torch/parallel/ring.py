"""Ring attention: attention over a sequence split into stripes around a ring.

Counterpart of ``lightglue_tpu/parallel/ring.py``. Each ring position holds
one Q stripe and starts with the K/V block of the same rows; at every step
it merges the block it holds into its running online-softmax carries
(``kernels.attention.flash_attention_step``) and then receives the block
its predecessor held, so after ``ring`` steps every stripe has seen every
block without the full (N_q, N_kv) similarity existing anywhere. The merge
is algebraically exact, so the result is single-device attention up to fp
rounding.

In the JAX package the positions are the devices of a ``seq`` mesh axis
under ``shard_map``, and ``lax.ppermute`` moves the blocks. Here
``ring_attention`` runs the positions one after another in this process:
position i computes on ``devices[i]``, and a block moves to the next
position's device with ``.to(...)``, a real copy between two cards and no
copy at all when the ring repeats one card (``[cuda:0] * P``, the serial
ring that measures the path on one H100, as
``scripts/bench_ring_local.py`` did on one TPU). ``torch.distributed``
over several cards, overlapping a block's transfer with the step before
it, and sharding the per-token ops are the ring across processes (ROADMAP
queue 1 item 4).

Masking follows the repo contract: ``lengths`` (B, 2) GLOBAL [q_len,
kv_len]; padded KV columns are -1e30 before the softmax and padded Q rows
are 0.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from lightglue_tpu_torch.kernels.attention import _NEG_INF, flash_attention_step

AXIS_SEQ = "seq"

# rotate(k, v, src) -> the (k, v) block this position receives: the one its
# predecessor holds, which originated at position (src - 1) mod ring
Rotate = Callable[[torch.Tensor, torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor],
    *,
    idx: int,
    ring: int,
    rotate: Rotate,
    scale: Optional[float] = None,
    step: Callable = flash_attention_step,
) -> torch.Tensor:
    """One ring position's body (JAX :53-121).

    Args:
      q: (B, H, n, D) this position's Q stripe (n = N_q / ring).
      k, v: (B, H, nk, D) the K/V block that originated here.
      lengths: optional (B, 2) GLOBAL [q_len, kv_len].
      idx/ring: this position and the ring size.
      rotate: hands this position the next block after each step.
      step: the merge; ``flash_attention_step_plain`` runs the same loop on
        the plain version.

    Returns:
      (B, H, n, D) in q's dtype.
    """
    b, h, n, d = q.shape
    nk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, n, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    acc = torch.zeros((b, h, n, d), device=q.device)
    if lengths is not None:
        lengths = lengths.to(q.device, torch.int32)
    # step s merges the block that originated at position (idx - s) mod ring
    for s in range(ring):
        src = (idx - s) % ring
        m, l, acc = step(q, k, v, m, l, acc, lengths, idx * n, src * nk, scale=scale)
        if s + 1 < ring:
            k, v = rotate(k, v, src)
    out = acc / torch.where(l == 0.0, 1.0, l)
    if lengths is not None:
        rows = idx * n + torch.arange(n, device=q.device)  # global row ids of this stripe
        valid = rows[None, :] < lengths[:, :1]  # (B, n)
        out = torch.where(valid[:, None, :, None], out, 0.0)
    return out.to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    devices: Sequence[torch.device],
    scale: Optional[float] = None,
    step: Callable = flash_attention_step,
) -> torch.Tensor:
    """Sequence-split attention over the ring ``devices`` (JAX :124-168).

    Args:
      q: (B, H, N_q, D); k, v: (B, H, N_kv, D); both sequence lengths
        divisible by the ring size.
      lengths: optional (B, 2) global [q_len, kv_len].
      devices: the ring, one ``torch.device`` per position; it may repeat
        one card. Stripe i of q, k and v goes to ``devices[i]``.

    Returns:
      (B, H, N_q, D) in q's dtype, on q's device.
    """
    ring = len(devices)
    if q.shape[2] % ring or k.shape[2] % ring:
        raise ValueError(
            f"sequence dims {q.shape[2]}/{k.shape[2]} must divide the ring size {ring}")
    devices = [torch.device(dev) for dev in devices]
    qs = [t.to(dev) for t, dev in zip(q.chunk(ring, dim=2), devices)]
    ks = [t.to(dev) for t, dev in zip(k.chunk(ring, dim=2), devices)]
    vs = [t.to(dev) for t, dev in zip(v.chunk(ring, dim=2), devices)]
    outs = []
    for idx, dev in enumerate(devices):
        def rotate(_k, _v, src, dev=dev):
            # the block the predecessor holds now (it originated at src - 1),
            # copied onto this position's card from the card it started on
            prev = (src - 1) % ring
            return ks[prev].to(dev), vs[prev].to(dev)

        outs.append(ring_attention_local(qs[idx], ks[idx], vs[idx], lengths, idx=idx,
                                         ring=ring, rotate=rotate, scale=scale, step=step))
    return torch.cat([o.to(q.device) for o in outs], dim=2)

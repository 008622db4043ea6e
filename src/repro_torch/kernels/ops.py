"""Public wrappers around the port's kernels: the dispatch point.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain PyTorch version (``kernels/ref.py``), and only because it lies on the
CPU.  There is no fallback: a CUDA call that fails raises.  Each wrapper
counts its kernel launches in ``LAUNCHES`` (plain ints, CUDA launches only),
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import ref

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"paged_attention": 0, "policy_paged_attention": 0,
                             "awrp_select": 0, "awrp_select_rows": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def paged_attention(q, k_pages, v_pages, page_start, cur_pos):
    """Decode attention over a paged pool; returns ``(out, page_mass)``
    (``repro.kernels.ops.paged_attention``)."""
    if q.device.type == "cpu":
        return ref.paged_attention_plain(q, k_pages, v_pages, page_start, cur_pos)
    from repro_torch.kernels.paged_attn import paged_attention_kernel

    res = paged_attention_kernel(q, k_pages, v_pages, page_start, cur_pos)
    LAUNCHES["paged_attention"] += 1
    return res


def policy_paged_attention(q, k_pages, v_pages, new_k, new_v, pos: int,
                           f, r, page_start, clock, open_slot, *, policy: str):
    """One fused flat-policy decode step; returns ``(out, page_mass, slot,
    f', r', page_start', clock', open_slot')``
    (``repro.kernels.ops.policy_paged_attention``).  The caller scatters the
    new K/V row at ``slot``."""
    if q.device.type == "cpu":
        return ref.policy_paged_attention_plain(
            q, k_pages, v_pages, new_k, new_v, pos, f, r, page_start, clock,
            open_slot, policy=policy)
    from repro_torch.kernels.policy_attn import policy_paged_attention_kernel

    res = policy_paged_attention_kernel(
        q, k_pages, v_pages, new_k, new_v, pos, f, r, page_start, clock,
        open_slot, policy=policy)
    LAUNCHES["policy_paged_attention"] += 1
    return res


def awrp_select(f, r, clock, valid, pinned):
    """(B, P) int32 metadata, 0/1 valid/pinned, (B,) int32 clock -> (B,)
    int32 victim slots (paper eq. (1)) over ``valid & ~pinned`` lanes
    (``repro.kernels.ops.awrp_select``, without its lane padding)."""
    if f.device.type == "cpu":
        return ref.awrp_select_plain(f, r, clock, valid, pinned)
    from repro_torch.kernels.awrp_select import awrp_select_kernel

    res = awrp_select_kernel(f, r, clock, valid, pinned)
    LAUNCHES["awrp_select"] += 1
    return res


def awrp_select_rows(f, r, clock, valid):
    """(B, P) int32 metadata -> (B,) int32 victims, all rows in one launch:
    the batched sweep engine's victim search, called once per trace step
    with B = the flat-policy rows of the grid
    (``repro.kernels.ops.awrp_select_rows``)."""
    if f.device.type == "cpu":
        return ref.awrp_select_rows_plain(f, r, clock, valid)
    from repro_torch.kernels.awrp_select import awrp_select_rows_kernel

    res = awrp_select_rows_kernel(f, r, clock, valid)
    LAUNCHES["awrp_select_rows"] += 1
    return res

"""Chunked SSD scan of Mamba2 (kernel B5): the CUDA kernel, its plain
PyTorch version, and the launch counts.

Port of ``repro/kernels/ssd_scan.py::ssd_scan``, extended to the function
the serving path runs, the reference's ``models/ssm.py::ssd_chunked``: an
initial state (zero when None) and the final state as a second output.
With ``init_state`` None and the final state dropped it is the TPU
kernel's function.  The sequence is cut into chunks of ``chunk`` tokens
(``chunk`` divides S); within a chunk the output is the masked quadratic
SSD form, across chunks the (H, P, N) state is carried.

Dispatch is by the inputs' device, as in ``paged_attention.py``: CPU →
``ssd_chunked_plain``, CUDA → ``csrc/ssd_scan.cu`` or raise.  The kernel
is built for head dim 64 and state widths 128 (mamba2) and 64 (zamba2)
and takes chunks of up to ``KERNEL_MAX_CHUNK`` tokens; other widths raise
on the card.
``COUNTS["kernel"]`` counts calls that launched the kernel, one per call
whether or not the C.B^T workspace adds a first launch.

The wrapper picks the kernel's regime: ``cb_workspace``, from the chunk
length, whether a first launch computes C.B^T once per lane and chunk for
all heads.

``xh``, ``Bm``, ``Cm`` and ``init_state`` are all float32 or all bfloat16
on the card (``KERNEL_DTYPES``; the launch layer's bf16 steps); ``dt``
and ``A`` may be either and are widened to float32 by the wrapper (S·H
and H elements).  Both the kernel and the plain version compute the
Pallas body's function: every input widened to float32, float32
accumulation, and y and the final state rounded once to ``xh``'s dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bump, plain_here
from repro_torch.kernels.paged_attention import check_no_grad, check_tensor

COUNTS = {"kernel": 0, "plain": 0}

# the widths csrc/ssd_scan.cu is compiled for: head dim, state widths,
# longest chunk
KERNEL_HEAD_DIM, KERNEL_STATES, KERNEL_MAX_CHUNK = 64, (64, 128), 8192
# chunks longer than this get C.B^T from the workspace launch
CB_WORKSPACE_ABOVE = 32
# the data dtypes the kernel is built for, and their launchers
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def cb_workspace(chunk: int) -> bool:
    """Whether C.B^T comes from a first launch that computes it once per
    (lane, chunk) for every head, rather than from every block: above 32
    tokens, where an H100 sweep (PERF.md) put the workspace first (at one
    lane's 32-token chunk its second launch saves nothing).  The workspace
    holds Lp floats a token (``workspace_floats``) for the call's length:
    0.5 KB a token at the model's 128-token chunks, a fortieth of x's 20
    KB at mamba2's widths; a whole prompt run as one chunk (plain
    generation of a length the model's chunk does not divide) takes more,
    2.3 MB a lane at 763 tokens and 256 MiB at 8192 (x there: 160 MiB).
    Without it, each of a head's four blocks would recompute the chunk's
    whole triangle of C.B^T."""
    return chunk > CB_WORKSPACE_ABOVE


def workspace_floats(B: int, S: int, chunk: int) -> int:
    """The C.B^T workspace: an Lp x Lp tile per (lane, chunk), Lp the
    chunk rounded up to 16 rows."""
    lp = -(-chunk // 16) * 16
    return B * (S // chunk) * lp * lp


def ssd_scan(xh, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """xh: (B, S, H, P); dt: (B, S, H); A: (H,) (negative decay rates);
    Bm / Cm: (B, S, N) (one SSM group, shared across heads); init_state:
    (B, H, P, N) or None.  Returns (y (B, S, H, P), final_state
    (B, H, P, N)), both in xh's dtype."""
    if xh.shape[1] % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} does not divide "
                         f"S {xh.shape[1]}")
    check_no_grad("ssd_scan", xh, dt, A, Bm, Cm, init_state)
    if plain_here(xh):
        return ssd_chunked_plain(xh, dt, A, Bm, Cm, chunk, init_state)
    if xh.device.type != "cuda":
        raise RuntimeError(f"ssd_scan: no kernel for {xh.device}")
    return _launch(xh, dt, A, Bm, Cm, chunk, init_state)


def _launch(xh, dt, A, Bm, Cm, chunk, init_state):
    from repro_torch.kernels import build
    dev = xh.device
    if xh.dtype not in KERNEL_DTYPES:
        raise ValueError(f"ssd_scan: the kernel takes float32 or bfloat16 "
                         f"data, got {xh.dtype}")
    dt, A = dt.float(), A.float()
    check_tensor("xh", xh, xh.dtype, dev, 4)
    check_tensor("dt", dt, torch.float32, dev, 3)
    check_tensor("A", A, torch.float32, dev, 1)
    check_tensor("Bm", Bm, xh.dtype, dev, 3)
    check_tensor("Cm", Cm, xh.dtype, dev, 3)
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape != (B, S, N) \
            or Cm.shape != (B, S, N):
        raise ValueError("ssd_scan: inconsistent shapes")
    if init_state is not None:
        check_tensor("init_state", init_state, xh.dtype, dev, 4)
        if init_state.shape != (B, H, P, N):
            raise ValueError("ssd_scan: init_state must be (B, H, P, N)")
    if P != KERNEL_HEAD_DIM or N not in KERNEL_STATES \
            or chunk > KERNEL_MAX_CHUNK:
        raise ValueError(
            f"ssd_scan: the kernel takes head dim {KERNEL_HEAD_DIM}, states "
            f"{KERNEL_STATES} and chunks up to {KERNEL_MAX_CHUNK}, got P {P}, "
            f"N {N}, chunk {chunk}")
    y = torch.empty_like(xh)
    final = torch.empty(B, H, P, N, dtype=xh.dtype, device=dev)
    h0 = None if init_state is None else init_state.data_ptr()
    cb = (torch.empty(workspace_floats(B, S, chunk), dtype=torch.float32,
                      device=dev) if cb_workspace(chunk) else None)
    fn = build.load("ssd_scan", KERNEL_DTYPES[xh.dtype])
    rc = fn(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), h0, y.data_ptr(), final.data_ptr(),
            None if cb is None else cb.data_ptr(), B, S, H, P, N, chunk,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    bump(COUNTS, "kernel")
    return y, final


def ssd_chunked_plain(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """The reference's ``ssd_chunked`` line for line: a loop over chunks
    carrying the state, the intra-chunk decay masked to -1e30 BEFORE the
    exp (the upper triangle would overflow), in float32.  Every input is
    widened to float32 first and y and the final state are rounded once to
    ``xh``'s dtype, as the Pallas body does (``repro/kernels/ssd_scan.py``:
    ``astype(jnp.float32)`` on entry, ``y.astype(o_ref.dtype)``); the
    model's ``ssd_chunked`` instead runs bf16 operands through bf16
    einsums.  Float32 inputs are used as they are."""
    bump(COUNTS, "plain")
    out_dtype = xh.dtype
    xh, dt, A, Bm, Cm = (t.float() for t in (xh, dt, A, Bm, Cm))
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xc = xh.reshape(Bsz, nc, chunk, H, P).transpose(0, 1)
    dtc = dt.reshape(Bsz, nc, chunk, H).transpose(0, 1)
    Bc = Bm.reshape(Bsz, nc, chunk, N).transpose(0, 1)
    Cc = Cm.reshape(Bsz, nc, chunk, N).transpose(0, 1)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=xh.device))
    h = (torch.zeros(Bsz, H, P, N, device=xh.device) if init_state is None
         else init_state.float())
    ys = []
    for c in range(nc):
        xk, dtk, Bk, Ck = xc[c], dtc[c], Bc[c], Cc[c]
        dA = dtk * A[None, None, :]                         # (B, L, H) <= 0
        seg = torch.cumsum(dA, dim=1)
        diff = seg[:, :, None, :] - seg[:, None, :, :]
        diff = torch.where(mask[None, :, :, None], diff, -1e30)
        decay = torch.exp(diff)
        cb = torch.einsum("bln,bmn->blm", Ck, Bk)           # (B, L, M)
        att = cb[..., None] * decay                         # (B, L, M, H)
        y_intra = torch.einsum("blmh,bmh,bmhp->blhp", att, dtk, xk)
        # inter-chunk: contribution of the incoming state
        y_inter = torch.einsum("bln,blh,bhpn->blhp", Ck, torch.exp(seg), h)
        # state at the end of the chunk
        decay_to_end = torch.exp(seg[:, -1:, :] - seg)      # (B, L, H)
        st = torch.einsum("bln,blh,blh,blhp->bhpn", Bk, dtk, decay_to_end,
                          xk)
        h = h * torch.exp(dA.sum(dim=1))[..., None, None] + st
        ys.append((y_intra + y_inter).to(out_dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y, h.to(out_dtype)

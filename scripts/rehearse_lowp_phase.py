#!/usr/bin/env python
"""Rehearse ``chip_smoke.py``'s phases of the kernels' remaining dtypes on
the CPU.

Those phases are: the float16 pools' (every B1-B4 case over fp16 pools,
``fp16_streams`` on the spec and MLA scripts, ``fp16_spec_replay`` and
``fp16_mla_replay``), the bf16 inputs' kernel phase (B1 with bf16 queries,
B5 and B6 over bf16 inputs: ``lowp_kernel_phase``) and
``bf16_launch_steps`` (the launch layer's bf16 prefill and serve steps of
whisper-large-v3 and mamba2-2.7b through B6 and B5).  Their control flow
(shapes, groups, decode steps, verifies, the launch counts they check, the
pool bytes) does not depend on the device, so it can be checked here
before it costs chip time.  This runs them on the CPU: the kernel phases
at the card's shapes, the serving and launch phases at the reduced widths
(deepseek-v2 cut to ``MLA_CUT``'s three layers; the launch steps at their
full depth, ``--depth`` to cut it), with the phases' CUDA-only calls
replaced by host stand-ins.  The attention module's calls of the paged
wrappers, and the model's calls of B5 and B6 (which run the plain versions
on the CPU), count as kernel launches; the yardsticks' plain versions
count as plain calls.

``--kernel-error R`` makes the launch steps' "kernel" runs of B5 and B6
compute in float32 and move every output by a relative error of R times a
normal draw before they round it to bf16, as a kernel whose float32 sums
run in another order than its plain version's would: it shows how far
such roundings, carried through the layers, move the logits against the
plain run (``worst_logit_err_over_tol``).  Times are host times of the CPU
and mean nothing for the card.

  PYTHONPATH=src python scripts/rehearse_lowp_phase.py \\
      [--only fp16|kernels|launch] [--kernel-error 1e-6] [--depth N]

It prints the phases' lines (and exits non-zero on a failed check).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# factories the phases call with device="cuda"
_FACTORIES = ("Generator", "randn", "randint", "randperm", "tensor",
              "arange", "zeros", "ones", "empty", "full", "linspace")


def _on_host(fn):
    def call(*a, **k):
        if str(k.get("device", "")).startswith("cuda"):
            k["device"] = "cpu"
        return fn(*a, **k)
    return call


def _host_torch():
    """``torch`` as the phases see it: the card's device is the CPU, the
    CUDA calls host stand-ins (``rehearse_cluster_phase._TorchOnHost``)."""
    from rehearse_cluster_phase import _HostCuda, _TorchOnHost

    class _Props:
        multi_processor_count = 132

    class _Cuda(_HostCuda):
        @staticmethod
        def get_device_properties(_):
            return _Props()

    class _Torch(_TorchOnHost):
        cuda = _Cuda

        def __getattr__(self, name):
            obj = getattr(torch, name)
            return _on_host(obj) if name in _FACTORIES else obj
    return _Torch()


def _count_as_kernel(mod, owner, name):
    """Calls of ``owner.name`` (a wrapper that runs its plain version on
    the CPU) counted as launches of ``mod``'s kernel."""
    fn = getattr(owner, name)

    def counted(*a, **k):
        out = fn(*a, **k)
        mod.COUNTS["plain"] -= 1
        mod.COUNTS["kernel"] += 1
        return out
    setattr(owner, name, counted)
    return fn


def _emulated_kernels(rel: float, sk, fa, seed: int):
    """Stand-ins for the wrappers of B5 and B6 that count a kernel launch
    and return the plain version's float32 result moved by ``rel`` x a
    normal draw, rounded to the inputs' dtype (``rel`` 0: the plain
    version's own result)."""
    g = torch.Generator().manual_seed(seed)
    plain_ssd, plain_flash = sk.ssd_chunked_plain, fa.flash_attention_plain

    def moved(t, dtype):
        if rel:
            t = t * (1 + rel * torch.randn(t.shape, generator=g))
        return t.to(dtype)

    def launched(mod):               # the plain call, counted as a launch
        mod.COUNTS["plain"] -= 1
        mod.COUNTS["kernel"] += 1

    def ssd(xh, dt, A, Bm, Cm, *, chunk, init_state=None):
        f = [None if t is None else t.float()
             for t in (xh, Bm, Cm, init_state)]
        y, h = plain_ssd(f[0], dt, A, f[1], f[2], chunk, f[3])
        launched(sk)
        return moved(y, xh.dtype), moved(h, xh.dtype)

    def flash(q, k, v, *, causal=True, q_offset=0, kv_len=None, scale=None):
        out = plain_flash(
            q.float(), k.float(), v.float(), causal=causal,
            q_offset=int(q_offset),
            kv_len=k.shape[1] if kv_len is None else int(kv_len),
            scale=q.shape[-1] ** -0.5 if scale is None else float(scale))
        launched(fa)
        return moved(out, q.dtype)
    return ssd, flash


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("fp16", "kernels", "launch"),
                    default=None)
    ap.add_argument("--kernel-error", type=float, default=0.0)
    ap.add_argument("--depth", type=int, default=None,
                    help="cut the launch steps' models to N layers")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import (flash_attention, mla_paged_prefill,
                                     paged_attention, paged_prefill,
                                     paged_verify, ssd_scan)
    from repro_torch.models import attention as at
    from repro_torch.models import init_params

    cs.torch = _host_torch()
    cs.card_line = lambda: "cpu rehearsal"
    cs.time_ms = lambda fn: 1.0        # host stand-in, never zero
    cs.cuda_profile = lambda fn, n=1, flush=True: None
    cs.flush_l2 = lambda: None
    kernels = {"decode": paged_attention, "prefill": paged_prefill,
               "verify": paged_verify, "mla_prefill": mla_paged_prefill,
               "ssd": ssd_scan, "flash": flash_attention}
    f16, seed = torch.float16, args.seed
    try:
        if args.only in (None, "kernels"):
            cs.decode_phase(paged_attention, f16, timed=cs.F16_DECODE_TIMED)
            cs.prefill_phase(paged_prefill, f16,
                             timed=cs.F16_PREFILL_TIMED)
            cs.verify_phase(paged_verify, None, f16,
                            timed=cs.F16_VERIFY_TIMED)
            cs.mla_prefill_phase(mla_paged_prefill, f16,
                                 timed=cs.F16_MLA_TIMED)
            cs.lowp_kernel_phase(paged_attention, flash_attention, ssd_scan)
        # from here the model's wrapper calls count as kernel launches
        for name, mod in (("paged_decode_attention", paged_attention),
                          ("paged_prefill_attention", paged_prefill),
                          ("paged_verify_attention", paged_verify),
                          ("mla_paged_prefill_attention",
                           mla_paged_prefill)):
            _count_as_kernel(mod, at, name)
        if args.only in (None, "fp16"):
            cfg = get_reduced(cs.SPEC_ARCH)
            params = init_params(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu")
            wants = cs.spec_stream_phase(cfg, params, seed)
            f32 = cs.spec_replay_phase(cfg, params, kernels, seed)
            prompts = cs.spec_prompts(cfg, seed)
            draft = cs.one_layer_draft(cfg, torch.device("cpu"), seed + 7)
            cs.kv16_streams_phase(
                "spec", cfg, params, prompts,
                lambda dtype: cs.spec_script(cfg, params, prompts, draft,
                                             dtype)[0], wants, f16)
            cs.spec_replay_phase(cfg, params, kernels, seed, f16, f32=f32)
            cfg = dataclasses.replace(get_reduced(cs.MLA_ARCH), **cs.MLA_CUT)
            params = init_params(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu")
            wants = cs.mla_stream_phase(cfg, params, seed)
            f32 = cs.mla_replay_phase(cfg, params, kernels, seed)
            prompts = cs.script_prompts(cfg, seed + 3)
            cs.kv16_streams_phase(
                "mla", cfg, params, prompts,
                lambda dtype: cs.run_script(cfg, params, prompts,
                                            cs.STREAM_SCRIPT, max_len=256,
                                            dtype=dtype)[0], wants, f16)
            cs.mla_replay_phase(cfg, params, kernels, seed, f16, f32=f32)
        if args.only in (None, "launch"):
            ssd_scan.ssd_scan, flash_attention.flash_attention_bh = \
                _emulated_kernels(args.kernel_error, ssd_scan,
                                  flash_attention, seed)
            import repro_torch.configs as configs

            def reduced(arch):
                """``arch`` at its reduced widths and its published depth
                (``--depth`` cuts it), as ``get_config`` for the phase."""
                cfg = get_reduced(arch)
                n = args.depth or get_config(arch).n_layers
                return dataclasses.replace(
                    cfg, n_layers=n,
                    block_pattern=(cfg.block_pattern * n)[:n])
            configs.get_config = reduced
            cs.bf16_launch_steps_phase(kernels, seed)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

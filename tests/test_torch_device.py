"""The device is always explicit: without CUDA every entry point called
with no ``device`` raises instead of falling back to the CPU, kernel
wrappers refuse devices they have no kernel for, and every module imports
without ``nvcc`` or a card.  The absence of CUDA is simulated, so these
checks mean the same on a machine that has a card."""
import importlib
import importlib.util
import io
import pkgutil
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch                                              # noqa: E402
from repro_torch import bridge, device                          # noqa: E402
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.kernels import build                           # noqa: E402
from repro_torch.kernels import paged_attention as pa           # noqa: E402
from repro_torch.kernels import paged_prefill as pp             # noqa: E402
from repro_torch.kernels import paged_verify as pv              # noqa: E402
from repro_torch.launch import serve                            # noqa: E402
from repro_torch.models import (init_paged_cache,               # noqa: E402
                                init_params)
from repro_torch.serving.engine import ServingEngine            # noqa: E402
from repro_torch.serving.kvcache import PagedKVManager          # noqa: E402


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_every_module_imports_without_nvcc_or_card():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert {"repro_torch.kernels.paged_prefill",
            "repro_torch.serving.cluster", "repro_torch.core.simulator",
            "repro_torch.core.router", "repro_torch.core.baselines",
            "repro_torch.configs.opt", "repro_torch.core.trace",
            "repro_torch.serving.gateway"} <= set(names)
    assert {f"repro_torch.telemetry.{m}" for m in (
        "registry", "timeseries", "exporters", "instruments",
        "autoscaler")} <= set(names)
    for name in names:
        importlib.import_module(name)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu").type == "cpu"
    cfg = get_reduced("smollm-135m")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_cache(cfg, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVManager(cfg, total_pages=4, page_size=4)
    arrays = {"w": np.zeros(2, np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.params_from_numpy(arrays)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.pools_from_numpy({"k_pages": np.zeros((2, 4, 1, 8))})
    params = init_params(cfg, gen, device="cpu")
    assert bridge.params_from_numpy(arrays, device="cpu")["w"].is_cpu
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, draft=(cfg, params))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build(serve.parse_args(["--reduced"]))
    from repro_torch.core.perf_model import cpu_scale_perf_model
    from repro_torch.serving.cluster import ClusterFrontend
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterFrontend.build(cfg, params, 2, cpu_scale_perf_model())


def test_kernel_wrappers_refuse_other_devices():
    B, S, H, KVH, hd, page = 1, 2, 2, 1, 8, 4
    meta = dict(device="meta")
    q = torch.empty(B, H, hd, **meta)
    pages = torch.empty(3, page, KVH, hd, **meta)
    table = torch.zeros(B, 2, dtype=torch.int32, **meta)
    lens = torch.ones(B, dtype=torch.int32, **meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        pa.paged_decode_attention(q, pages, pages, table, lens)
    qs = torch.empty(B, S, H, hd, **meta)
    kn = torch.empty(B, S, KVH, hd, **meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        pp.paged_prefill_attention(qs, kn, kn, pages, pages, table, lens,
                                   lens)
    with pytest.raises(RuntimeError, match="no kernel"):
        pv.paged_verify_attention(qs, kn, kn, pages, pages, table, lens,
                                  lens)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("paged_decode")
    assert not (tmp_path / "kernels").exists()


def test_chip_smoke_refuses_without_cuda(no_cuda):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with redirect_stdout(out):
        assert mod.main() != 0
    assert out.getvalue() == ""

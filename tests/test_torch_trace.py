"""The port's ``roofline/trace.py`` (the counterpart of the JAX package's
``roofline/hlo.py``) on the CPU.

The ring factors equal the reference's ``_wire_factor`` for every kind and
group size, and ``summarize`` gives the reference's dict on the same ops.
Two ``gloo`` processes run an ``all_reduce`` and an ``all_gather`` under
``torch.profiler`` (in a subprocess, with a timeout): the trace gives
group size 2 and the ring bytes.  A synthetic chrome trace with NCCL and
K1-K6b kernel names, and ``record_param_comms`` events as NCCL records
them, is classified and parsed as stated; a CPU trace of a reduced model's
prefill parses with 0 collectives and 0 wire bytes.
"""

import dataclasses
import gzip
import json
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.roofline import hlo  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.roofline import trace as T  # noqa: E402

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
         "broadcast")
GROUPS = (1, 2, 4, 16, 256, 512)


@pytest.mark.parametrize("kind", KINDS)
def test_wire_factors_equal_the_reference(kind):
    for g in GROUPS:
        assert T._wire_factor(kind, g) == hlo._wire_factor(kind, g), (kind, g)


def test_summarize_equals_the_reference():
    rows = [("all-reduce", "bf16", (16, 512), 4), ("all-gather", "f32", (256, 512), 16),
            ("all-reduce", "f32", (7,), 2), ("collective-permute", "f32", (4, 4), 2),
            ("reduce-scatter", "bf16", (8, 8), 512)]
    ours, theirs = [], []
    for kind, dt, shape, g in rows:
        nbytes = int(torch.tensor(shape).prod()) * (2 if dt == "bf16" else 4)
        fields = dict(kind=kind, dtype=dt, shape=shape, group_size=g, result_bytes=nbytes,
                      wire_bytes=int(nbytes * hlo._wire_factor(kind, g)))
        ours.append(T.CollectiveOp(**fields))
        theirs.append(hlo.CollectiveOp(**fields))
    assert [f.name for f in dataclasses.fields(T.CollectiveOp)] == [
        f.name for f in dataclasses.fields(hlo.CollectiveOp)]
    assert T.summarize(ours) == hlo.summarize(theirs)
    assert T.summarize([]) == hlo.summarize([]) == {"by_kind": {}, "wire_bytes": 0, "n_ops": 0}


_GLOO = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.profiler import ProfilerActivity, profile

    def run(rank, port, out):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        x = torch.ones(1000, dtype=torch.float32)
        parts = [torch.empty(500, dtype=torch.bfloat16) for _ in range(2)]
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            dist.all_reduce(x)
            dist.all_gather(parts, torch.full((500,), float(rank), dtype=torch.bfloat16))
        assert float(x[0]) == 2.0 and float(parts[1][0]) == 1.0
        if rank == 0:
            prof.export_chrome_trace(out)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(int(sys.argv[1]), sys.argv[2]), nprocs=2)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_a_two_process_gloo_trace_gives_group_size_and_ring_bytes(tmp_path):
    script, out = tmp_path / "gloo.py", tmp_path / "trace.json"
    script.write_text(_GLOO)
    res = subprocess.run([sys.executable, str(script), str(_free_port()), str(out)],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    trace = T.read(str(out))
    ops = T.parse_collectives(trace)
    assert [(o.kind, o.dtype, o.group_size) for o in ops] == [
        ("all-reduce", "float32", 2), ("all-gather", "bfloat16", 2)]
    ar, ag = ops
    assert ar.result_bytes == 1000 * 4 and ar.wire_bytes == 1000 * 4 * 2 * 1 // 2
    assert ag.shape == (1000,) and ag.result_bytes == 2 * 500 * 2
    assert ag.wire_bytes == ag.result_bytes // 2
    s = T.summarize(ops)
    assert s["wire_bytes"] == ar.wire_bytes + ag.wire_bytes and s["n_ops"] == 2
    assert T.kernel_classes(trace) == {}  # a CPU run has no device events


def _kernel(name, dur_us, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": 0, "dur": dur_us, "args": {}}


SYNTHETIC = [
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "NCCL"),
    ("void move_lanes_kernel<uint4>(char const*, char*, long long const*)", "K1/K2/K6b move_lanes"),
    ("gather_bulk_kernel(char const*, char*, long long const*, long long, int)", "K6a gather_bulk"),
    ("heat_scan_kernel(float*, long long const*, float const*, int)", "K3 heat_scan"),
    ("void paged_decode_g4_kernel<__nv_bfloat16, 64>(...)", "K4 paged_decode"),
    ("void paged_decode_wide_kernel<__nv_bfloat16, 192, 16>(...)", "K4 paged_decode"),
    ("void (anonymous namespace)::lru_scan_kernel<float, true, 32>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float const*, float*, "
     "(anonymous namespace)::Plan)", "K5 lru_scan"),
    ("void lru_scan_bwd_kernel<float>(float const*, ...)", "K5 bwd lru_scan_bwd"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNN", "GEMM"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "GEMM"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16>(...)", "GEMM"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_kernel_cuda"
     "(at::TensorIteratorBase&)::{lambda()#3}>(...)", "copy or memset"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, MaxOps<float>>>(...)",
     "reduction"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>(...)", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float>>(...)",
     "elementwise"),
    ("void at::native::index_select_large_index<float, long>(...)", "other"),
]


def test_a_synthetic_trace_is_classified_as_stated():
    events = [_kernel(n, 10.0 * (i + 1)) for i, (n, _) in enumerate(SYNTHETIC)]
    events += [_kernel("Memcpy HtoD (Pageable -> Device)", 5.0, "gpu_memcpy"),
               _kernel("Memset (Device)", 1.0, "gpu_memset"),
               _kernel("aten::mm", 99.0, "cpu_op"),  # host events carry no device time
               _kernel("cudaLaunchKernel", 7.0, "cuda_runtime")]
    for name, cls in SYNTHETIC:
        assert T.kernel_class(name) == cls, name
    classes = T.kernel_classes({"traceEvents": events})
    want: dict[str, list] = {}
    for i, (_, cls) in enumerate(SYNTHETIC):
        want.setdefault(cls, [0.0, 0])
        want[cls][0] += 10.0 * (i + 1) / 1e3
        want[cls][1] += 1
    want["copy or memset"][0] += 6.0 / 1e3
    want["copy or memset"][1] += 2
    assert classes.keys() == want.keys()
    for k, v in classes.items():
        assert [v["device_ms"], v["launches"]] == pytest.approx(want[k]), k
    ms = [v["device_ms"] for v in classes.values()]
    assert ms == sorted(ms, reverse=True)
    assert T.parse_collectives(events) == []  # kernels are not messages


def test_record_param_comms_events_are_read_as_nccl_records_them(tmp_path):
    def comms(name, dtype, n_in, n_out, g):
        return {"ph": "X", "cat": "cpu_op", "name": "record_param_comms", "ts": 0, "dur": 1,
                "args": {"Collective name": name, "dtype": dtype, "In msg nelems": n_in,
                         "Out msg nelems": n_out, "Group size": g}}

    events = [comms("allreduce", "Float", 1024, 1024, 8),
              comms("_allgather_base", "BFloat16", 128, 1024, 8),
              comms("reduce_scatter_tensor_coalesced", "BFloat16", 1024, 128, 8),
              comms("all_to_all", "Float", 64, 64, 4),
              comms("send", "Float", 10, 10, 2),
              comms("allreduce", "ComplexHalf", 4, 4, 2),  # no torch dtype: skipped
              # a gloo annotation beside them is not read twice
              {"ph": "X", "cat": "user_annotation", "name": "gloo:all_reduce", "dur": 1,
               "args": {"Input type": ["float"], "Input Dims": [[1024]]}}]
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    ops = T.parse_collectives(T.read(str(path)))
    assert [(o.kind, o.dtype, o.shape, o.group_size) for o in ops] == [
        ("all-reduce", "float32", (1024,), 8), ("all-gather", "bfloat16", (1024,), 8),
        ("reduce-scatter", "bfloat16", (128,), 8), ("all-to-all", "float32", (64,), 4),
        ("collective-permute", "float32", (10,), 2)]
    assert [o.wire_bytes for o in ops] == [
        int(4096 * hlo._wire_factor("all-reduce", 8)), int(2048 * 7 / 8), 256 * 7,
        int(256 * 3 / 4), 40]


def test_a_cpu_trace_of_a_reduced_step_has_no_collectives(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    cfg = reduce(get_config("granite_3_2b"))
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        lm.prefill(model, ids, cfg, 32)
    path = str(tmp_path / "step.trace.json.gz")
    prof.export_chrome_trace(path)
    trace = T.read(path)
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])
    assert T.parse_collectives(trace) == []
    assert T.summarize(T.parse_collectives(trace))["wire_bytes"] == 0
    assert T.kernel_classes(trace) == {}

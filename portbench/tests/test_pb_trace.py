"""The reduction of a trace, on a synthetic one."""

import pytest

from portbench import spec, trace


def synthetic():
    # device: kernels at [0,10), [5,20) (overlap), [30,40), [60,70) us; window 100 us
    dev = [("void topk_cluster_kernel<bf16>(x)", 0.0, 10.0, 1), ("gemm", 5.0, 20.0, 2),
           ("w8_gemm_kernel<32>", 30.0, 40.0, 3), ("copy", 60.0, 70.0, 4)]
    host = [("pb.search", 0.0, 50.0, 7), (trace.LAUNCH + "matmul_topk_bf16:1,256,768,1048576,10", 0.5, 1.0, 7),
            ("pb.chunk", 25.0, 45.0, 8), (trace.LAUNCH + "w8_matmul:32,3072,3072,64,132", 26.0, 27.0, 8)]
    runtime = [("cuLaunchKernelEx", 0.6, 0.7, 1, 7), ("cudaLaunchKernel", 2.0, 2.1, 2, 7),
               ("cuLaunchKernelEx", 26.5, 26.6, 3, 8), ("cudaLaunchKernel", 55.0, 55.1, 4, 9)]
    return trace.reduce(dev, host, runtime, 100.0)


def test_busy_and_idle():
    r = synthetic()
    assert r["busy_s"] == pytest.approx(40e-6)  # 20 + 10 + 10
    assert r["window_s"] == pytest.approx(100e-6)
    gaps = dict(r["idle_gaps"])
    # [20,30) inside pb.search; [40,60) opens at 40 in pb.chunk (opened last); [70,100) in no span
    assert gaps["pb.search"] == pytest.approx(10e-6)
    assert gaps["pb.chunk"] == pytest.approx(20e-6)
    assert gaps["(no span)"] == pytest.approx(30e-6)
    rec = {"trace": r}
    for name in ("idle.search", "idle.gen_closed", "idle.ingest", "idle.gen_poisson"):
        assert spec.load_module("metrics", name).read(rec) == pytest.approx(60.0)


def test_launches_and_chunk_busy():
    r = synthetic()
    (ints, secs), = r["launches"]["matmul_topk_bf16"]
    assert ints == [1, 256, 768, 1048576, 10] and secs == pytest.approx(10e-6)
    (ints, secs), = r["launches"]["w8_matmul"]
    assert ints[:3] == [32, 3072, 3072] and secs == pytest.approx(10e-6)
    # busy time over the chunks dispatched in the sub-window
    assert spec.load_module("metrics", "chunk_busy_ms").read({"trace": r, "traced_chunks": 4}) == pytest.approx(0.01)
    assert r["device_ops"][0][0] == "gemm"
    assert trace.short_name("void topk_cluster_kernel<bf16>(x)") == "topk_cluster_kernel<bf16>"


def test_nothing_traced_reads_nothing():
    r = trace.reduce([], [], [], 100.0)
    assert r["busy_s"] == 0.0 and r["launches"] == {}
    assert spec.load_module("metrics", "topk_roofline").read({"trace": r}) is None
    assert spec.load_module("metrics", "chunk_busy_ms").read({"trace": r, "traced_chunks": 0}) is None


def test_w8_roofline_from_a_tally():
    from portbench import roofline

    r = trace.reduce([("w8_gemm_kernel<32>", 0.0, 10.0, 1), ("w8_gemm_kernel<32>", 20.0, 30.0, 2)], [], [], 100.0)
    r["tally"] = [("w8_matmul", [32, 3072, 3072, 64, 132])] * 2 + [("flash_attention_fwd", [0] * 8)]
    b = roofline.bound_s(*roofline.w8_call(32, 3072, 3072))
    assert spec.load_module("metrics", "w8_roofline").read({"trace": r}) == pytest.approx(100 * 2 * b / 20e-6)

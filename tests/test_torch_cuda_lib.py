"""Thread safety of the port's kernel library and launch counters.

The sharded store serves each shard's sub-batch on its own thread, so
kernels launch from several threads at once: a counter's bump must lose no
count, and the first launches must build and load the library once.  Both
run here on the CPU, with the build and the loader replaced by fakes.
"""
import sys
import threading
import types

from repro_torch.kernels import cuda_lib


def _run_threads(n, target, timeout=60.0):
    barrier = threading.Barrier(n)
    errors = []

    def body():
        try:
            barrier.wait(timeout)
            target()
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=body) for _ in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter allows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    assert errors == []


def test_counter_loses_no_bump_under_threads():
    c = cuda_lib.LaunchCounter("hammered")
    n_threads, n_bumps = 16, 5000
    _run_threads(n_threads, lambda: [c.bump() for _ in range(n_bumps)])
    assert c.n == n_threads * n_bumps
    c.reset()
    assert c.n == 0


def test_registered_counters_reset_and_list():
    c = cuda_lib.register_counter("test_torch_cuda_lib_counter")
    try:
        c.bump()
        assert cuda_lib.launch_counters()["test_torch_cuda_lib_counter"].n == 1
        cuda_lib.reset_launch_counters()
        assert c.n == 0
    finally:
        del cuda_lib._COUNTERS["test_torch_cuda_lib_counter"]


def test_library_builds_and_loads_once_under_threads(tmp_path, monkeypatch):
    builds, loads = [], []

    def fake_build(self, out):
        builds.append(out)
        threading.Event().wait(0.05)  # a slow nvcc: the other threads arrive meanwhile
        out.write_bytes(b"")

    def fake_cdll(path):
        loads.append(path)
        return types.SimpleNamespace(**{
            name: types.SimpleNamespace() for name in cuda_lib._SIGNATURES})

    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib.KernelLibrary, "_build", fake_build)
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", fake_cdll)
    lib = cuda_lib.KernelLibrary()
    got = []
    _run_threads(12, lambda: got.append(lib.get()))
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 12 and all(g is got[0] for g in got)
    assert lib.path == builds[0]
    for name, argtypes in cuda_lib._SIGNATURES.items():
        fn = getattr(got[0], name)
        assert fn.argtypes == list(argtypes) and fn.restype is cuda_lib.ctypes.c_int
    assert lib.get() is got[0] and len(loads) == 1  # later calls reuse it

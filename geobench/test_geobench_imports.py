"""No run holds JAX, the JAX package or the old benchmarks; the reference
holds nothing of the port either.  Checked in a fresh interpreter, by the
top-level module name before the first dot (``repro_torch`` is not
``repro``)."""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _tops(code: str) -> set:
    probe = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_nothing_banned():
    tops = _tops("import geobench.run, geobench.harness, geobench.tracing, geobench.sweep\n"
                 "import repro_torch.core.store, repro_torch.serve.scheduler\n"
                 "import repro_torch.distributed.sharded_store")
    assert not tops & BANNED
    assert "repro_torch" in tops


def test_reference_loads_nothing_of_the_program():
    tops = _tops("import geobench.reference.check, geobench.reference.route\n"
                 "import geobench.reference.placement, geobench.control")
    assert not tops & (BANNED | {"repro_torch"})

"""The port's sharded model paths hold the values of its plain ones on a
real ``(2, 4)`` ``("data", "model")`` mesh of 8 gloo ranks, each a process
on the CPU (``tests/_torch_mesh_rank.py`` runs a rank and says how the
steps are compared):

- training steps (loss and every gradient leaf): qwen3 (GQA: its 2 kv
  heads do not divide ``model``, so each rank slices the kv heads its q
  heads read), deepseek (MLA and MoE) and equiformer-v2 (segment sums and
  maxima, row gathers, its column regions);
- decode steps (logits and the updated caches): the batch split, and the
  cache's sequence split over ``data`` (qwen3's with the head width split
  over ``model`` too; deepseek's MLA);
- ``all_reduce_region``'s max, whose gradient must reach only the ranks
  that hold the maximum (split between two ranks that tie).
"""
import pytest

from _torch_mesh_rank import check, spawn

CASES = ["qwen3_train", "deepseek_train", "qwen3_decode", "qwen3_decode_seq",
         "deepseek_decode_seq", "equiformer_train", "max_region"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("mesh_2x4"), (2, 4), CASES)


@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_plain(results, case):
    check(results, case)

"""The port's sharded model paths hold the values of its plain ones on a
real ``(2, 2)`` ``("data", "model")`` mesh of 4 gloo ranks, each a process
on the CPU (``tests/_torch_mesh_rank.py`` runs a rank and says how the
steps are compared): the training steps of qwen3 (GQA) and deepseek (MLA
and MoE), gemma3's decode step with the cache's sequence split over
``data`` and its sliding window, and the training steps of schnet, egnn
and meshgraphnet (segment sums and means, row gathers).
"""
import pytest

from _torch_mesh_rank import check, spawn

CASES = ["qwen3_train", "deepseek_train", "gemma3_decode_seq", "schnet_train", "egnn_train",
         "meshgraphnet_train"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("mesh_2x2"), (2, 2), CASES)


@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_plain(results, case):
    check(results, case)

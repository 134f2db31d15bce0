"""The yardstick's arithmetic against hand counts: FLOPs and bytes from
shapes (GIT's mask with its text triangle), the interval union and idle
gaps of a trace, percentiles."""

import math

import pytest

from port_bench import flops, stats, trace
from port_bench.tests import tiny


def test_git_pairs_by_hand():
    # 2 image tokens, 3 text tokens of which 2 are unpadded:
    # image rows 2 x 2; text rows see 2 image columns each (3 x 2) and
    # text columns 1, 2, 2
    assert flops.git_pairs(2, 3, 2) == 4 + 6 + 5
    assert flops.git_pairs(0, 4, 4) == 10        # the plain causal square
    assert flops.git_pairs(3, 0, 0) == 9


def test_git_pairs_is_the_masks_count():
    import torch
    from port_bench.reference.git import git_mask
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]])
    ok = git_mask(4, mask)
    for row, n in zip(ok[:, 0], (3, 5)):
        assert int(row.sum()) == flops.git_pairs(4, 5, n)


def test_vision_and_text_flops_by_hand():
    c = tiny.tiny_git_config()
    v = c["vision_config"]
    d, f, t = 32, 64, 5           # 32 px / 16 -> 4 patches + class token
    per_frame = (2 * 4 * 3 * 16 * 16 * d
                 + v["num_hidden_layers"] * (2 * t * d * (4 * d + 2 * f)
                                             + 4 * t * t * d)
                 + 2 * t * d * c["hidden_size"])
    assert flops.vision_fwd(c, 3) == pytest.approx(3 * per_frame)
    m, l, n = 10, 6, 4
    s = m + l
    want = (c["num_hidden_layers"] * (2 * s * d * (4 * d + 2 * f)
                                      + 4 * d * flops.git_pairs(m, l, n))
            + 2 * 5 * d * c["vocab_size"])
    assert flops.text_fwd(c, m, l, [n], 5) == pytest.approx(want)
    micro = flops.git_train_micro(c, 2, l, [n, n])
    assert micro == pytest.approx(
        3 * (flops.vision_fwd(c, 4) + flops.text_fwd(c, 10, l, [n, n],
                                                     l - 1)))


def test_flash_bounds():
    c = {"num_attention_heads": 2, "hidden_size": 128}
    b = flops.git_flash_bounds(c, 1000, 24, [24, 10])
    pairs = flops.git_pairs(1000, 24, 24) + flops.git_pairs(1000, 24, 10)
    fwd_flops = 4 * 64 * 2 * pairs
    t = 2 * 2 * 1024 * 64 * 2
    fwd_bytes = 4 * t + 2 * 2 * 1024 * 4 + 2 * 24 * 4
    assert b["fwd"] == pytest.approx(max(fwd_flops / 989e12,
                                         fwd_bytes / 3.35e12))
    assert b["bwd"] == pytest.approx(max(2.5 * fwd_flops / 989e12,
                                         (8 * t + 2 * 2 * 1024 * 4
                                          + 2 * 24 * 4) / 3.35e12))


def test_union_and_gaps():
    assert trace.union_ns([]) == 0
    assert trace.union_ns([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25
    recs = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 40, 41)]
    assert trace.gaps_ns(recs) == [("after c", 10), ("after b", 5)]
    s = trace.summary({"wall_s": 1e-7, "records": recs})
    assert s["busy_s"] == pytest.approx(26e-9)
    assert s["kernels"] == 4
    assert s["breakdown"]["device_ops"][0] == ["a", 1e-8]


def test_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2], 50) == 1.5
    with pytest.raises(ValueError):
        stats.percentile([], 50)
    assert math.isclose(stats.percentile([5, 1, 3], 100), 5)

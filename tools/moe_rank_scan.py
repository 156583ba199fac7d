"""Time the MoE capacity ranking's token scan: blocked against one scan.

`models.moe._rank` counts each expert's earlier assignments with an
inclusive cumsum of a (tokens, experts) one-hot over its token axis. On
the card one ``cumsum`` along that axis runs a thread per column, so at
granite-moe-3b-a800m's scoring shape (8,192 tokens, 40 experts) it walks
8,192 rows in turn; `moe._cumsum_tokens` scans blocks of 256 tokens and
adds the earlier blocks' totals (the same integers). This script prints,
twice in turn, the time of one scan each way (CUDA events, mean of 50),
of the whole V1/V3 ranking (`capacity_and_rank`, top 8) with each, and
how many such scans one scoring forward makes (8 a layer, 32 layers).

    python3 tools/moe_rank_scan.py
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCH = "granite-moe-3b-a800m"
TOKENS = cs.SCORE_SHAPE[0] * cs.SCORE_SHAPE[1]


def plain_scan(oh):
    return oh.cumsum(dim=-2)


def mean_ms(fn, iters=50) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    cs.phase_device()
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.rand((TOKENS, cfg.n_experts), device="cuda",
                     generator=gen).topk(cfg.n_experts_per_tok).indices
    oh = F.one_hot(idx[:, 0], cfg.n_experts)
    blocked = moe._cumsum_tokens
    cs.check(torch.equal(blocked(oh), plain_scan(oh)),
             "blocked scan differs from one scan")
    want = moe.capacity_and_rank(cfg, idx, TOKENS)
    for turn in range(2):
        for name, scan in (("one scan", plain_scan), ("blocked", blocked)):
            moe._cumsum_tokens = scan
            got = moe.capacity_and_rank(cfg, idx, TOKENS)
            cs.check(got[0] == want[0] and torch.equal(got[1], want[1])
                     and torch.equal(got[2], want[2]),
                     f"{name}: ranks differ")
            scan_ms = mean_ms(lambda: scan(oh))
            rank_ms = mean_ms(lambda: moe.capacity_and_rank(cfg, idx,
                                                            TOKENS))
            cs.say(f"[moe rank] turn {turn}, {name}: (T, E) = ({TOKENS}, "
                   f"{cfg.n_experts}) int64 scan {scan_ms:.4f} ms, "
                   f"capacity_and_rank (k {cfg.n_experts_per_tok}) "
                   f"{rank_ms:.4f} ms; a scoring forward scans "
                   f"{cfg.n_experts_per_tok * cfg.n_layers} times")
    moe._cumsum_tokens = blocked


if __name__ == "__main__":
    main()

"""mf_roofline: the share of the match finder's device time (every device
operation launched inside match_finder.find_candidates: the hashing,
torch.sort and the select kernel) that reading the window's input bytes
once at the card's peak memory rate would take (%)."""
from qzbench import stats

SPANS = {"mf": "qatzip_tpu_torch.ops.match_finder:find_candidates",
         "mf_packed":
             "qatzip_tpu_torch.ops.match_finder:find_candidates_packed"}


def read(run):
    peak = run.peaks.get("hbm_bytes_per_s")
    dev = [run.device_s(s) for s in ("mf", "mf_packed")]
    dev = [d for d in dev if d is not None]
    if run.direction != "compress" or not peak or not dev:
        return None
    return stats.roofline_pct(run.raw_bytes, peak, sum(dev))

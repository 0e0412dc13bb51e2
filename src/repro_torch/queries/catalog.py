"""The paper's 13 queries (Table 1): naive plans + ground-truth evaluators.

Q1–Q9 run on the Toll Booth stream, Q10–Q13 on Volleyball.  Each query
provides:
  * ``naive_plan()`` — Source -> MLLMExtract(all needed tasks) -> relational
    tail -> Sink (every frame through the big MLLM: the paper's baseline);
  * ``evaluate(result)`` — query-level accuracy against stream labels
    (per-car / per-event / per-window semantics, matching how the paper
    scores correctness rather than raw per-frame agreement).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.tollbooth import BRANDS, COLORS, PLATE_CHARS
from repro_torch.data.volleyball import ACTIONS
from repro_torch.streaming.operators import (
    FilterOp,
    MLLMExtractOp,
    SinkOp,
    SourceOp,
    WindowAggOp,
)
from repro_torch.streaming.plan import Plan

WINDOW = 256


# ---------------------------------------------------------------------------
# label helpers
# ---------------------------------------------------------------------------

def car_passes(labels: List[Dict]) -> List[Dict]:
    """Group consecutive readable frames of the same plate into passes."""
    passes = []
    cur = None
    for l in labels:
        if l.get("car_readable") and l.get("plate"):
            if cur is not None and cur["plate"] == l["plate"] \
                    and l["index"] - cur["last"] <= 3:
                cur["last"] = l["index"]
                cur["frames"].append(l["index"])
            else:
                if cur:
                    passes.append(cur)
                cur = {"plate": l["plate"], "color": l["color"],
                       "brand": l["brand"], "stolen": l["stolen"],
                       "first": l["index"], "last": l["index"],
                       "frames": [l["index"]]}
        elif cur is not None and l["index"] - cur["last"] > 3:
            passes.append(cur)
            cur = None
    if cur:
        passes.append(cur)
    return passes


def _attr_by_frame(outputs: List[Dict], field: str) -> Dict[int, Any]:
    return {o["idx"]: o[field] for o in outputs if field in o}


def _per_car_accuracy(outputs, labels, field, vocab) -> float:
    """A car pass is correct if any emitted frame in its span matches GT."""
    passes = car_passes(labels)
    if not passes:
        return 1.0
    by_frame = _attr_by_frame(outputs, field)
    ok = 0
    for p in passes:
        truth = p[field] if field != "plate" else p["plate"]
        hit = False
        for fidx in range(p["first"], p["last"] + 1):
            if fidx in by_frame:
                pred = by_frame[fidx]
                if field == "plate":
                    pred_s = "".join(PLATE_CHARS[int(c)] for c in pred)
                    hit = pred_s == truth
                else:
                    hit = vocab[int(pred)] == truth
                if hit:
                    break
        ok += hit
    return ok / len(passes)


def _windows(labels: List[Dict], window: int) -> List[List[Dict]]:
    n = labels[-1]["index"] + 1 if labels else 0
    return [[l for l in labels if w0 <= l["index"] < w0 + window]
            for w0 in range(0, n - window + 1, window)]


def _window_results(result, kind: str) -> List[Dict]:
    """Window results of one kind, one per window span.

    flush() emits the open window early, marked ``partial``; when a
    segmented (snapshot/resume) run later closes the same window, the
    closed result supersedes the partial one (and a fresher partial
    supersedes a staler one), so positional indexing against ground-truth
    windows stays aligned."""
    best: Dict[Tuple, Dict] = {}      # insertion-ordered by window span
    for w in result.window_results:
        if w["kind"] != kind:
            continue
        key = tuple(w["window"])
        if key not in best or best[key].get("partial"):
            best[key] = w
    return list(best.values())


def _event_f1(pred_events: List[int], true_spans: List[Tuple[int, int]],
              slack: int = 2) -> float:
    """Match notification frames to true event spans."""
    if not true_spans:
        return 1.0 if not pred_events else 0.0
    matched = set()
    tp = 0
    fp = 0
    for e in pred_events:
        hit = None
        for i, (a, b) in enumerate(true_spans):
            if a - slack <= e <= b + slack:
                hit = i
                break
        if hit is None:
            fp += 1
        else:
            matched.add(hit)
    tp = len(matched)
    fn = len(true_spans) - tp
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-9)


# ---------------------------------------------------------------------------
# Query definitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Query:
    qid: str
    description: str
    dataset: str                       # tollbooth | volleyball
    tasks: Tuple[str, ...]
    tail: Callable[[], List]           # relational tail ops (fresh instances)
    evaluate: Callable[[Any], float]
    #: semantic hints the optimizer reads from the *query* (not the data)
    needs_color: bool = False
    needs_plate: bool = False
    needs_fine_detail: bool = False    # plates/brand stripes need resolution
    filter_color: Optional[str] = None

    def naive_plan(self) -> Plan:
        ops = [SourceOp(stream_name=self.dataset),
               MLLMExtractOp(tasks=self.tasks, model="big")]
        ops += self.tail()
        ops.append(SinkOp())
        return Plan(ops, query=self.qid)


def _eval_q1(result):
    return _per_car_accuracy(result.outputs, result.labels, "brand", BRANDS)


def _eval_q2(result):
    return _per_car_accuracy(result.outputs, result.labels, "color", COLORS)


def _eval_q3(result):
    return _per_car_accuracy(result.outputs, result.labels, "plate", None)


def _topk_window_eval(result, labels, field, vocab, kind, key):
    wins = _window_results(result, kind)
    gt_wins = _windows(labels, WINDOW)
    if not gt_wins:
        return 1.0
    ok, tot = 0, 0
    for i, wl in enumerate(gt_wins):
        truth_counts = Counter(l[field] for l in wl
                               if l.get("car_readable") and l.get(field))
        if not truth_counts:
            continue
        truth = truth_counts.most_common(1)[0][0]
        pred = wins[i][key] if i < len(wins) and wins[i].get(key) else None
        tot += 1
        ok += pred == truth
    return ok / max(tot, 1)


def _eval_q4(result):
    a = _topk_window_eval(result, result.labels, "brand", BRANDS,
                          "top_brand_color", "top_brand")
    b = _topk_window_eval(result, result.labels, "color", COLORS,
                          "top_brand_color", "top_color")
    return 0.5 * (a + b)


def _eval_q5(result):
    return _topk_window_eval(result, result.labels, "brand", BRANDS,
                             "top_brand", "top_brand")


def _eval_q6(result):
    return _topk_window_eval(result, result.labels, "color", COLORS,
                             "top_color", "top_color")


def _eval_q7(result):
    wins = _window_results(result, "repeated_plates")
    gt_wins = _windows(result.labels, WINDOW)
    ok, tot = 0, 0
    for i, wl in enumerate(gt_wins):
        passes = car_passes(wl)
        c = Counter(p["plate"] for p in passes)
        truth = set(pl for pl, k in c.items() if k >= 2)
        pred = set(wins[i]["repeated"]) if i < len(wins) else set()
        tot += 1
        if truth or pred:
            inter = len(truth & pred)
            union = len(truth | pred)
            ok += inter / max(union, 1)
        else:
            ok += 1
    return ok / max(tot, 1)


def _eval_q8(result):
    # notifications = frames that survived the stolen-car filter
    pred_events = [o["idx"] for o in result.outputs]
    passes = [p for p in car_passes(result.labels) if p["stolen"]]
    spans = [(p["first"], p["last"]) for p in passes]
    return _event_f1(pred_events, spans)


def _eval_q9(result):
    wins = _window_results(result, "count_distinct_plates")
    gt_wins = _windows(result.labels, WINDOW)
    ok, tot = 0, 0
    for i, wl in enumerate(gt_wins):
        truth = len(set(p["plate"] for p in car_passes(wl)))
        pred = wins[i]["distinct_plates"] if i < len(wins) else 0
        tot += 1
        ok += 1.0 - min(abs(pred - truth) / max(truth, 1), 1.0)
    return ok / max(tot, 1)


def _eval_q10(result):
    wins = _window_results(result, "count_jumping")
    gt_wins = _windows(result.labels, WINDOW)
    ok, tot = 0, 0
    for i, wl in enumerate(gt_wins):
        truth = sum(l["n_jumping"] for l in wl)
        pred = wins[i]["total_jumping"] if i < len(wins) else 0
        tot += 1
        ok += 1.0 - min(abs(pred - truth) / max(truth, 1), 1.0)
    return ok / max(tot, 1)


def _eval_q11(result):
    # offense proxy scored on spike counts per window
    wins = _window_results(result, "top_team")
    gt_wins = _windows(result.labels, WINDOW)
    ok, tot = 0, 0
    for i, wl in enumerate(gt_wins):
        truth = sum(1 for l in wl if l["action"] == "spike")
        pred = wins[i]["spikes"] if i < len(wins) else 0
        tot += 1
        ok += 1.0 - min(abs(pred - truth) / max(truth, 1), 1.0)
    return ok / max(tot, 1)


def _eval_q12(result):
    pred_events = [o["idx"] for o in result.outputs]
    spans = []
    start = None
    for l in result.labels:
        if l["action"] == "spike" and start is None:
            start = l["index"]
        elif l["action"] != "spike" and start is not None:
            spans.append((start, l["index"] - 1))
            start = None
    if start is not None:
        spans.append((start, result.labels[-1]["index"]))
    return _event_f1(pred_events, spans)


def _eval_q13(result):
    wins = _window_results(result, "top3_actions")
    gt_wins = _windows(result.labels, WINDOW)
    ok, tot = 0, 0
    for i, wl in enumerate(gt_wins):
        c = Counter(l["action"] for l in wl)
        truth = set(a for a, _ in c.most_common(3))
        pred = set(wins[i]["top3"]) if i < len(wins) else set()
        tot += 1
        ok += len(truth & pred) / max(len(truth | pred), 1)
    return ok / max(tot, 1)


QUERIES: Dict[str, Query] = {
    "Q1": Query("Q1", "Car brand recognition", "tollbooth",
                ("present", "brand"),
                lambda: [FilterOp(("eq", "present", 1))], _eval_q1,
                needs_fine_detail=True),
    "Q2": Query("Q2", "Car color recognition", "tollbooth",
                ("present", "color"),
                lambda: [FilterOp(("eq", "present", 1))], _eval_q2,
                needs_color=True),
    "Q3": Query("Q3", "License plate detection", "tollbooth",
                ("present", "plate"),
                lambda: [FilterOp(("eq", "present", 1))], _eval_q3,
                needs_plate=True, needs_fine_detail=True),
    "Q4": Query("Q4", "Most popular brand & color", "tollbooth",
                ("present", "brand", "color"),
                lambda: [FilterOp(("eq", "present", 1)),
                         WindowAggOp("top_brand_color", WINDOW)], _eval_q4,
                needs_color=True, needs_fine_detail=True),
    "Q5": Query("Q5", "Most popular brand", "tollbooth",
                ("present", "brand"),
                lambda: [FilterOp(("eq", "present", 1)),
                         WindowAggOp("top_brand", WINDOW)], _eval_q5,
                needs_fine_detail=True),
    "Q6": Query("Q6", "Most popular color", "tollbooth",
                ("present", "color"),
                lambda: [FilterOp(("eq", "present", 1)),
                         WindowAggOp("top_color", WINDOW)], _eval_q6,
                needs_color=True),
    "Q7": Query("Q7", "Repeated car detection", "tollbooth",
                ("present", "plate"),
                lambda: [FilterOp(("eq", "present", 1)),
                         WindowAggOp("repeated_plates", WINDOW)], _eval_q7,
                needs_plate=True, needs_fine_detail=True),
    "Q8": Query("Q8", "Red stolen 'MTT' car", "tollbooth",
                ("present", "color", "plate"),
                lambda: [FilterOp(("and", ("eq", "present", 1),
                                   ("and", ("eq", "color", "red"),
                                    ("prefix", "plate", "MTT"))))], _eval_q8,
                needs_color=True, needs_plate=True, needs_fine_detail=True,
                filter_color="red"),
    "Q9": Query("Q9", "Unique license plates", "tollbooth",
                ("present", "plate"),
                lambda: [FilterOp(("eq", "present", 1)),
                         WindowAggOp("count_distinct_plates", WINDOW)],
                _eval_q9, needs_plate=True, needs_fine_detail=True),
    "Q10": Query("Q10", "Amount of jumping players", "volleyball",
                 ("action", "n_jumping"),
                 lambda: [WindowAggOp("count_jumping", WINDOW)], _eval_q10),
    "Q11": Query("Q11", "Most offensive team", "volleyball",
                 ("action", "team"),
                 lambda: [WindowAggOp("top_team", WINDOW)], _eval_q11),
    "Q12": Query("Q12", "Notify when someone spikes", "volleyball",
                 ("action",),
                 lambda: [FilterOp(("eq", "action", "spike"))], _eval_q12),
    "Q13": Query("Q13", "3 most common actions", "volleyball",
                 ("action",),
                 lambda: [WindowAggOp("top3_actions", WINDOW)], _eval_q13),
}


def get_query(qid: str) -> Query:
    return QUERIES[qid]

"""Dictionary-recovery diagnostics: classify why atoms were missed.

Counterpart of ``prosper_tpu/data/diagnosis.py`` (numpy), with the port's
``data/bars.py::cosine_match`` and ``engine/em.py::coactivation_split``.

TPU-build addition beyond the reference (no counterpart in SURVEY.md §2 —
the reference only counts recovered bars).  Round-1/2 experience at the
patches scale showed that *guessing* recovery levers wastes chip runs while
one host-side diagnosis of a converged dictionary classifies every failure
immediately (ROUND1.md / ROUND2.md).  The measured signatures this module
encodes:

* **blend** — one learned column ``w ~= a_i + a_j`` fuses two ground-truth
  atoms with near-disjoint supports.  Signature: its top-2 cosines against
  the ground truth are both moderate (~0.5-0.85), and its *support size* is
  ~2x the median (support, not norm, is the sharp statistic: the M-step
  rescales blends BELOW the median norm).
* **duplicate** — two learned columns lock onto the same atom (mutual
  cosine above ~0.85), wasting one column; some other atom then goes
  uncovered.
* **dead** — a column whose norm decayed far below the median (no
  sufficient statistics flow to it, the ridge M-step shrinks it).
* **missing** — an atom with no learned column near it and no blend
  containing it (pure capacity loss; random re-seeding is the lever).

``EM(revive_duplicates=..., split_coact=True, reseed_worst_frac=...)``
consumes exactly these signals online; this module is the offline analysis
used to calibrate them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from prosper_tpu_torch.data.bars import cosine_match


def dictionary_stats(W: np.ndarray, support_frac: float = 0.25) -> Dict:
    """Per-column health statistics of a (D, H) dictionary (no ground truth).

    Returns norms, support sizes (pixels above ``support_frac`` of the
    column's peak magnitude), the mutual-coherence matrix, and the medians
    the online revival heuristics compare against.
    """
    W = np.asarray(W, np.float64)
    norms = np.linalg.norm(W, axis=0)
    absW = np.abs(W)
    support = (absW > support_frac * (absW.max(axis=0, keepdims=True) + 1e-30)
               ).sum(axis=0)
    Wn = W / (norms + 1e-12)
    coherence = Wn.T @ Wn
    np.fill_diagonal(coherence, 0.0)
    return {
        "norms": norms,
        "support": support,
        "coherence": coherence,
        "median_norm": float(np.median(norms)),
        "median_support": float(np.median(support)),
        "max_coherence": float(np.abs(coherence).max(initial=0.0)),
    }


def diagnose_recovery(W_learned: np.ndarray, W_true: np.ndarray,
                      threshold: float = 0.8, signed: bool = False,
                      blend_band: tuple = (0.45, 0.92),
                      dup_threshold: float = 0.85,
                      dead_norm_frac: float = 0.1,
                      support_factor: float = 1.5,
                      support_frac: float = 0.25) -> Dict:
    """Classify every unrecovered ground-truth atom of a converged run.

    Parameters mirror the online revival knobs: ``dup_threshold`` is
    ``revive_duplicates[1]``, ``dead_norm_frac`` its 4th element,
    ``support_factor`` is ``split_norm_frac`` under ``split_coact``.

    Returns a dict with

    - ``recovered`` / ``missed``: ground-truth atom indices (cosine above /
      below ``threshold`` under the optimal assignment);
    - ``blends``: learned-column -> (atom_i, atom_j, cos_i, cos_j) for
      columns showing the blend signature;
    - ``duplicates``: list of (learned_i, learned_j, cosine) pairs above
      ``dup_threshold`` (the weaker-norm column listed second);
    - ``dead``: learned columns below ``dead_norm_frac`` x median norm;
    - ``missed_classes``: atom index -> one of ``"blend"`` / ``"missing"``
      (an atom eaten by a blend column vs. nowhere present);
    - ``stats``: the `dictionary_stats` of ``W_learned``.
    """
    Wl = np.asarray(W_learned, np.float64)
    Wt = np.asarray(W_true, np.float64)
    assignment, cosines = cosine_match(Wl, Wt, signed=signed)
    recovered = np.flatnonzero(cosines > threshold)
    missed = np.flatnonzero(cosines <= threshold)

    stats = dictionary_stats(Wl, support_frac=support_frac)
    nl = stats["norms"] + 1e-12
    nt = np.linalg.norm(Wt, axis=0) + 1e-12
    C = (Wt / nt).T @ (Wl / nl)                  # (H_true, H_learned)
    score = np.abs(C) if signed else C

    # blend signature: top-2 gt cosines both inside the band AND support
    # well above median (the support side kills single-atom false positives)
    blends: Dict[int, tuple] = {}
    lo, hi = blend_band
    sup_gate = support_factor * max(stats["median_support"], 1.0)
    order = np.argsort(-score, axis=0)
    for col in range(Wl.shape[1]):
        a, b = int(order[0, col]), int(order[1, col])
        ca, cb = float(score[a, col]), float(score[b, col])
        if lo <= cb and ca <= hi and stats["support"][col] >= sup_gate:
            blends[col] = (a, b, ca, cb)

    # duplicate pairs among learned columns (weaker norm second)
    duplicates = []
    coh = np.abs(stats["coherence"]) if signed else stats["coherence"]
    for i in range(Wl.shape[1]):
        for j in range(i + 1, Wl.shape[1]):
            if coh[i, j] > dup_threshold:
                pair = (i, j) if nl[i] >= nl[j] else (j, i)
                duplicates.append((*pair, float(coh[i, j])))

    dead = [int(h) for h in
            np.flatnonzero(stats["norms"]
                           < dead_norm_frac * stats["median_norm"])]

    blended_atoms = {atom for (a, b, *_ ) in
                     [(v[0], v[1]) for v in blends.values()]
                     for atom in (a, b)}
    missed_classes = {int(t): ("blend" if int(t) in blended_atoms
                               else "missing")
                      for t in missed}

    return {"assignment": assignment, "cosines": cosines,
            "recovered": recovered, "missed": missed, "blends": blends,
            "duplicates": duplicates, "dead": dead,
            "missed_classes": missed_classes, "stats": stats}


def split_blend_sweep(W: np.ndarray, Y: np.ndarray,
                      support_factor: float = 1.5,
                      junk_support_factor: float = 3.0,
                      dup_threshold: float = 0.85,
                      dead_norm_frac: float = 0.1,
                      support_frac: float = 0.25,
                      contrast_threshold: float = 0.22,
                      relaxed_dup_threshold: float = 0.65) -> Dict:
    """Offline blend-split sweep over a CONVERGED dictionary (round 4,
    VERDICT r3 #5).

    Diagnosis of the 3-6 atom recovery tail (tools/patches_seed2_diag.npz,
    ROUND4.md): every residual miss is a *blend* column fusing two atoms
    (support ~2x median, two moderate gt-cosines), while the free capacity
    sits in junk columns (support >= ~3-4x median, no clean structure) and
    weaker duplicates.  The ONLINE splitter (EM.revive_duplicates +
    split_coact) only fires when revival frees a column, so at convergence
    blends outnumber the split opportunities.  This sweep fixes that
    directly, with NO ground truth:

      1. donors = weaker member of each duplicate pair + dead columns;
      2. blend candidates = columns with support >= support_factor x
         median, tried through ``coactivation_split`` (the data decides:
         a clean two-group co-activation structure == a real blend);
      3. candidates that FAIL the split and have support >=
         junk_support_factor x median are junk -> appended to donors;
      4. each successful split writes one part over the blend column and
         one over a donor;
      5. (round 5 — the taxonomy's "missing-no-donor" / "blend-no-donor"
         classes) when splits remain but donors ran out, the donor pool
         extends with weaker members of RELAXED duplicate pairs: learned
         coherence above ``relaxed_dup_threshold``.  Measured basis
         (seed-2 taxonomy dictionaries): the learned off-diagonal
         coherence bulk sits at <= 0.26 (planted-dictionary max 0.38)
         with a clean gap to the 0.7+ outliers, every one of which was a
         redundant near-duplicate (its atoms all covered elsewhere) —
         so 0.65 is far above the bulk yet catches donors the 0.85 gate
         misses.  Taken in DESCENDING coherence (safest first), only as
         needed.

    Returns {"W": new (D, H) array (a copy), "splits": [(blend_col,
    donor_col)], "donors_left": [...], "failed": [...]}.
    Run a short warm-start EM polish afterwards so the M-step rescales
    the split halves (prosper_tpu_torch/examples/patches_scale_run.py final stage).
    """
    from prosper_tpu_torch.engine.em import coactivation_split

    W = np.array(W, np.float64, copy=True)
    st = dictionary_stats(W, support_frac=support_frac)
    norms, support = st["norms"], st["support"]
    med_sup = max(st["median_support"], 1.0)

    donors: list = []
    used: set = set()
    coh = st["coherence"]
    for i in range(W.shape[1]):
        for j in range(i + 1, W.shape[1]):
            if coh[i, j] > dup_threshold:
                weaker = j if norms[i] >= norms[j] else i
                if weaker not in used:
                    donors.append(weaker)
                    used.add(weaker)
    for h in np.flatnonzero(norms < dead_norm_frac * st["median_norm"]):
        if int(h) not in used:
            donors.append(int(h))
            used.add(int(h))

    # support BAND (round-4 calibration on seed 2): true two-atom blends
    # sit at ~1.6-1.9x the median support; columns at >= junk_support_factor
    # x median are unstructured junk — they sometimes pass the coact split
    # spuriously, and splitting them burns donors, so they go STRAIGHT to
    # the donor pool (measured: splitting them cost 297 -> 291).  Split
    # candidates are tried ascending support (closest to the 2x blend
    # signature first) so true blends claim donors before wider columns.
    for h in np.flatnonzero(support >= junk_support_factor * med_sup):
        if int(h) not in used:
            donors.append(int(h))
            used.add(int(h))
    cands = [int(h) for h in np.argsort(support)
             if support_factor * med_sup <= support[h]
             < junk_support_factor * med_sup and int(h) not in used]
    # contrast gate 0.22 (vs 0.30 online): the support band above already
    # excludes single atoms, and the seed-2 diagnosis (ROUND4.md) measured
    # true blends at contrast 0.26-0.31
    splits_pending, failed = [], []
    for h in cands:
        parts = coactivation_split(W[:, h], Y,
                                   contrast_threshold=contrast_threshold)
        if parts is None:
            failed.append(h)
        else:
            splits_pending.append((h, parts))

    # relaxed-duplicate donor extension (docstring point 5): only when the
    # primary pool cannot serve every pending split.  A pending split
    # candidate that is itself the weaker member of a relaxed pair is a
    # REDUNDANT blend (its dominant atom is covered by the partner):
    # donating it outranks splitting it — the split would write two
    # already-covered parts while a non-redundant blend goes unserved
    # (observed on the seed-2 taxonomy dictionary: blend cols 16/105 were
    # exactly the 0.73-0.77-coherent weaker partners).
    if len(splits_pending) > len(donors) and relaxed_dup_threshold > 0:
        relaxed = []
        for i in range(W.shape[1]):
            for j in range(i + 1, W.shape[1]):
                if relaxed_dup_threshold < coh[i, j] <= dup_threshold:
                    # donate the REDUNDANT member: at relaxed coherence
                    # the pair is typically (clean atom, blend containing
                    # that atom) — support identifies the blend (measured
                    # on seed 2: norm picked the clean column and lost its
                    # atom; support 22-vs-8 picks the blend).  Ties fall
                    # back to the weaker norm.
                    if support[i] != support[j]:
                        weaker = i if support[i] > support[j] else j
                    else:
                        weaker = j if norms[i] >= norms[j] else i
                    if weaker not in used:
                        relaxed.append((coh[i, j], weaker))
        for _, w in sorted(relaxed, reverse=True):
            if w not in used and len(splits_pending) > len(donors):
                splits_pending = [(h, p) for h, p in splits_pending
                                 if h != w]
                donors.append(w)
                used.add(w)

    splits = []
    for h, (w1, w2) in splits_pending:
        if not donors:
            break
        d = donors.pop(0)
        W[:, h] = w1
        W[:, d] = w2
        splits.append((h, d))
    return {"W": W.astype(np.float32), "splits": splits,
            "donors_left": donors, "failed": failed}


def format_report(report: Dict, max_rows: int = 20) -> str:
    """Human-readable summary of a `diagnose_recovery` report."""
    st = report["stats"]
    lines = [
        f"recovered {report['recovered'].size}"
        f"/{report['cosines'].size} atoms "
        f"(median norm {st['median_norm']:.3g}, "
        f"median support {st['median_support']:.0f}, "
        f"max coherence {st['max_coherence']:.2f})",
    ]
    by_class: Dict[str, list] = {}
    for atom, cls in report["missed_classes"].items():
        by_class.setdefault(cls, []).append(atom)
    for cls, atoms in sorted(by_class.items()):
        lines.append(f"  missed/{cls}: {len(atoms)} -> "
                     f"{sorted(atoms)[:max_rows]}")
    for col, (a, b, ca, cb) in list(report["blends"].items())[:max_rows]:
        lines.append(f"  blend col {col}: atoms {a}+{b} "
                     f"(cos {ca:.2f}/{cb:.2f}, "
                     f"support {st['support'][col]:.0f})")
    for i, j, c in report["duplicates"][:max_rows]:
        lines.append(f"  duplicate cols {i}~{j} (cos {c:.2f})")
    if report["dead"]:
        lines.append(f"  dead cols: {report['dead'][:max_rows]}")
    return "\n".join(lines)

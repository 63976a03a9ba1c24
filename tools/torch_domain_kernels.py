#!/usr/bin/env python3
"""Time kernels D-G, J and K of the PyTorch port alone, per width class.

Run from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 tools/torch_domain_kernels.py [TREE ...]

Each TREE (by default this checkout) is a directory that holds a
``gecco_tpu_torch`` package: a variant of the kernels to compare.  Each
is timed in a process of its own, in the order given, so that variants
take turns on the same card (``A B B A``).  For each width class of 128
to 1,024 nodes of 2,766 Pfam-shaped profiles, two sets of rows against
3,000 synthetic proteins cut to 512 residues:

* ``clustered``: 400 rows over 25 profiles of the class, many rows a
  profile, a launch as short as the default search's (latency);
* ``dense``: 3,000 rows over every profile of the class, as the
  ``max_filter`` search's launches (throughput).

Kernel E takes kernel D's outputs for the same rows; kernel G takes
kernel F's planes and one envelope a row, the first that
``hmm.stream.envelopes`` finds from E's posteriors (the whole sequence
where it finds none); kernel J takes the rows as ``PairDomains`` does
(``emit_pe=False``), kernel K the rows, G's envelopes and D's scores.
Each launch is prepared beforehand (``hmm.stream.posterior_fwd_launches``,
``hmm.domains.pair_posterior_launches`` and the like) and timed alone
between CUDA events: the mean of 5 (clustered) or 2 (dense) launches
after a warm-up.  A tree without prepared launches for E, G, J or K
(before they took a block schedule) launches them through
``_Rows.launch``, set up beforehand in the same way.  Prints the card's
name and power limit, then one JSON line a tree.

    python3 tools/torch_domain_kernels.py --pair-domains [TREE ...]

times kernels J and K alone in the same way, per width class, over the
rows that ``PairDomains.define`` gives them on ``chip_smoke.py``'s phase
6: the F3 candidates of each tree's default search over
``bench_proteins()`` (the port's ``calibrate``), each launch group's
rows recorded as ``define`` makes them (the mean of 5 launches after a
warm-up, summed per class).

    python3 tools/torch_domain_kernels.py --domains [TREE ...]

runs each tree's ``max_filter`` search over ``chip_smoke.py``'s workload
(phase 4: ``bench_proteins()``, the port's ``calibrate``), each in a
process of its own, and prints every tree's count of domains, then each
pair whose domains (``StreamDomains.define``'s, before the reporting
threshold) differ between the first tree and another, with both lists and
the float64 host engine's (``hmm.engine.define_domains``, on the host),
and how many of those pairs each tree gets as the engine does.
"""

import functools
import json
import os
import subprocess
import sys
import warnings

CLASSES = (128, 256, 512, 1024)
N_PROFILES = 2766
N_PROTEINS = 3000


def time_tree(tree, pair_domains=False):
    """One JSON line of device ms per kernel, row set and width class
    (with ``pair_domains``, of kernels J and K over ``PairDomains.define``'s
    rows, and the rows per class)."""
    sys.path.insert(0, tree)
    sys.modules["jax"] = None
    import numpy
    import torch

    from gecco_tpu_torch import _build
    from gecco_tpu_torch.hmm import domains, stream
    from gecco_tpu_torch.hmm.bank import TorchBank
    from gecco_tpu_torch.hmm.kernels import SeqPack
    from gecco_tpu_torch.hmm.synthetic import pfam_shaped_profiles, synthetic_proteins

    if not stream.__file__.startswith(tree):
        raise RuntimeError(f"imported {stream.__file__}, not the package of {tree}")
    _build.library()
    device = torch.device("cuda")
    if pair_domains:
        bank, pack, groups = pair_domain_rows(domains, device)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            bank = TorchBank.build(pfam_shaped_profiles(N_PROFILES, seed=0), device)
        seqs = [x[:512] for x in synthetic_proteins(N_PROTEINS, mean_length=280, seed=3)]
        pack = SeqPack(seqs, device)

    def timed(fn, repeats):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / repeats

    def one_launch(launches, out):
        (launch,) = launches.values()
        return launch, out

    def posterior_bwd(s_idx, p_idx, traj, score):
        if hasattr(stream, "posterior_bwd_launches"):
            return one_launch(*stream.posterior_bwd_launches(pack, bank, s_idx, p_idx, traj,
                                                             score))
        rows = stream._Rows(pack, bank, s_idx, p_idx)
        post = torch.empty((2, rows.n, rows.stride), dtype=torch.float32, device=device)
        return functools.partial(rows.launch, "gecco_posterior_bwd", "posterior_bwd", traj,
                                 score, post), post

    def align_fwd(s_idx, p_idx, planes, logs, iv, jv, total):
        if hasattr(stream, "align_fwd_launches"):
            return one_launch(*stream.align_fwd_launches(pack, bank, s_idx, p_idx, planes, logs,
                                                         iv, jv, total))
        rows = stream._Rows(pack, bank, s_idx, p_idx)
        out = torch.empty((rows.n, 22), dtype=torch.float32, device=device)
        coords = torch.empty((rows.n, 4), dtype=torch.int32, device=device)
        env = [torch.as_tensor(a.astype(numpy.int32), device=device) for a in (iv, jv)]
        return functools.partial(rows.launch, "gecco_align_fwd", "align_fwd", planes, logs,
                                 *env, total, out, coords), (out, coords)

    def pair_posterior(s_idx, p_idx):
        if hasattr(domains, "pair_posterior_launches"):
            return one_launch(*domains.pair_posterior_launches(pack, bank, s_idx, p_idx,
                                                               emit_pe=False))
        rows = stream._Rows(pack, bank, s_idx, p_idx)
        score = torch.empty(rows.n, dtype=torch.float32, device=device)
        post = torch.empty((2, rows.n, rows.stride), dtype=torch.float32, device=device)
        return functools.partial(rows.launch, "gecco_pair_posterior", "pair_posterior", 2,
                                 score, post), (score, post)

    def pair_align(s_idx, p_idx, iv, jv, total):
        if hasattr(domains, "pair_align_launches"):
            return one_launch(*domains.pair_align_launches(pack, bank, s_idx, p_idx, iv, jv,
                                                           total))
        rows = stream._Rows(pack, bank, s_idx, p_idx)
        longest = int((jv - iv).max()) + 1
        planes = torch.empty((2, rows.n, longest, rows.width), dtype=torch.bfloat16,
                             device=device)
        logs = torch.empty((4, rows.n, longest), dtype=torch.float32, device=device)
        out = torch.empty((rows.n, 22), dtype=torch.float32, device=device)
        coords = torch.empty((rows.n, 4), dtype=torch.int32, device=device)
        env = [torch.as_tensor(a.astype(numpy.int32), device=device) for a in (iv, jv)]
        return functools.partial(rows.launch, "gecco_pair_align", "pair_align", *env, total,
                                 longest, planes, logs, out, coords), (out, coords)

    def first_envelopes(s_idx, post):
        """Each row's first envelope slot, else its whole sequence (host)."""
        lens = pack.lens[torch.as_tensor(s_idx, device=device)]
        env_i, env_j, _over = stream.envelopes(post[0], post[1], lens)
        ok = env_j >= env_i
        first = torch.argmax(ok.int(), dim=1, keepdim=True)
        has = ok.any(dim=1)
        iv = torch.where(has, env_i.gather(1, first)[:, 0], 1)
        jv = torch.where(has, env_j.gather(1, first)[:, 0], lens)
        return iv.cpu().numpy(), jv.cpu().numpy()

    if pair_domains:
        ms, rows = {}, {}
        for kernel, stage, make in (("J", "posterior", pair_posterior), ("K", "align", pair_align)):
            for group in groups[stage]:
                launch, _out = make(*group)
                key = f"{kernel} pair-domains {int(bank.class_of[group[1]].max())}"
                ms[key] = ms.get(key, 0.0) + timed(launch, 5)
                rows[key] = rows.get(key, 0) + len(group[0])
                del launch, _out
        print(json.dumps({"tree": tree, "ms": ms, "rows": rows}), flush=True)
        return

    rng = numpy.random.default_rng(0)
    ms = {}
    for width in CLASSES:
        members = numpy.flatnonzero(bank.class_of == width)
        for case, n, profiles, repeats in (("clustered", 400, members[:25], 5),
                                            ("dense", 3000, members, 2)):
            s_idx = rng.integers(0, len(seqs), n)
            p_idx = rng.choice(profiles, n)
            launch, (traj, score) = one_launch(*stream.posterior_fwd_launches(pack, bank, s_idx,
                                                                              p_idx))
            ms[f"D {case} {width}"] = timed(launch, repeats)
            launch, post = posterior_bwd(s_idx, p_idx, traj, score)
            ms[f"E {case} {width}"] = timed(launch, repeats)
            iv, jv = first_envelopes(s_idx, post)
            launch, (planes, logs) = one_launch(*stream.align_bwd_launches(pack, bank, s_idx,
                                                                           p_idx))
            ms[f"F {case} {width}"] = timed(launch, repeats)
            launch, _out = align_fwd(s_idx, p_idx, planes, logs, iv, jv, score)
            ms[f"G {case} {width}"] = timed(launch, repeats)
            del launch, planes, logs, _out
            launch, _out = pair_posterior(s_idx, p_idx)
            ms[f"J {case} {width}"] = timed(launch, repeats)
            launch, _out = pair_align(s_idx, p_idx, iv, jv, score)
            ms[f"K {case} {width}"] = timed(launch, repeats)
            del launch, traj, score, post, _out
            torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "ms": ms}), flush=True)


def pair_domain_rows(domains, device):
    """The bank, pack and rows of ``chip_smoke.py``'s phase 6: the default
    search's F3 candidates over ``bench_proteins()``, given to
    ``PairDomains.define``; returns ``(bank, pack, {"posterior": [(s_idx,
    p_idx), ...], "align": [(s_idx, p_idx, iv, jv, total), ...]})``, one
    entry per launch group of each stage (host arrays, ``total`` on the
    device)."""
    import numpy

    from gecco_tpu_torch.hmm.calibrate import calibrate
    from gecco_tpu_torch.hmm.kernels import SeqPack
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline
    from gecco_tpu_torch.hmm.synthetic import bench_proteins

    profiles, seqs = bench_proteins()
    calibrate(profiles, device=device)
    pipeline = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                              backend="cuda")
    pipeline.search(seqs)
    pairs = list(pipeline.candidate_pairs)
    pack = SeqPack(seqs, device)
    groups = {"posterior": [], "align": []}
    cls = domains.PairDomains
    posteriors, align = cls._posteriors, cls._align

    def record_posteriors(self, pack_, s_idx, p_idx):
        groups["posterior"].append((numpy.asarray(s_idx), numpy.asarray(p_idx)))
        return posteriors(self, pack_, s_idx, p_idx)

    def record_align(self, pack_, s_idx, p_idx, iv, jv, total):
        groups["align"].append(tuple(numpy.asarray(a) for a in (s_idx, p_idx, iv, jv))
                               + (total,))
        return align(self, pack_, s_idx, p_idx, iv, jv, total)

    cls._posteriors, cls._align = record_posteriors, record_align
    try:
        cls(pipeline.bank, profiles, backend="cuda").define(seqs, pairs, pack)
    finally:
        cls._posteriors, cls._align = posteriors, align
    return pipeline.bank, pack, groups


def max_filter_domains(tree, path):
    """Tree ``tree``'s ``max_filter`` search over ``chip_smoke.py``'s
    workload (phase 4): every domain ``StreamDomains.define`` found, as
    ``{"s p": [[ienv, jenv, target from, target to, hmm from, hmm to,
    bit score], ...]}``, and the domains the search reported, written to
    ``path`` as JSON."""
    sys.path.insert(0, tree)
    sys.modules["jax"] = None
    import torch

    from gecco_tpu_torch import _build
    from gecco_tpu_torch.hmm import stream
    from gecco_tpu_torch.hmm.calibrate import calibrate
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline
    from gecco_tpu_torch.hmm.synthetic import bench_proteins

    if not stream.__file__.startswith(tree):
        raise RuntimeError(f"imported {stream.__file__}, not the package of {tree}")
    _build.library()
    device = torch.device("cuda")
    profiles, seqs = bench_proteins()
    calibrate(profiles, device=device)
    found = {}
    define = stream.StreamDomains.define

    def recording_define(self, sequences, pairs, pack):
        out = define(self, sequences, pairs, pack)
        found.update({f"{s} {p}": [[d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from,
                                    d.hmm_to, d.bitscore] for d in doms]
                      for (s, p), doms in out.items()})
        return out

    stream.StreamDomains.define = recording_define
    pipeline = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                              max_filter=True, backend="cuda")
    hits = pipeline.search(seqs)
    with open(path, "w") as f:
        json.dump({"tree": tree, "reported": sum(len(h.domains) for h in hits),
                   "domains": found}, f)


def compare_domains(trees):
    """Each tree's ``max_filter`` domains (:func:`max_filter_domains`), each
    in a process of its own; prints the counts and every pair whose
    domains differ between the first tree and another."""
    import tempfile

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(trees):
            path = os.path.join(tmp, f"{i}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one-domains", tree,
                            path], check=True)
            with open(path) as f:
                runs.append(json.load(f))
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.modules["jax"] = None
    from gecco_tpu_torch.hmm import engine
    from gecco_tpu_torch.hmm.synthetic import bench_proteins

    profiles, seqs = bench_proteins()
    first = runs[0]
    for run in runs:
        print(json.dumps({"tree": run["tree"], "reported": run["reported"],
                          "pairs": len(run["domains"]),
                          "domains": sum(map(len, run["domains"].values()))}), flush=True)
    for run in runs[1:]:
        agree = {first["tree"]: 0, run["tree"]: 0}
        for key in sorted(set(first["domains"]) | set(run["domains"])):
            a, b = first["domains"].get(key), run["domains"].get(key)
            if a is None or b is None or [d[:6] for d in a] != [d[:6] for d in b]:
                s, p = map(int, key.split())
                want = [[d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to]
                        for d in engine.define_domains(profiles[p], seqs[s])]
                for tree, got in ((first["tree"], a), (run["tree"], b)):
                    agree[tree] += [d[:6] for d in got or []] == want
                print(json.dumps({"pair": key, first["tree"]: a, run["tree"]: b,
                                  "engine64": want}), flush=True)
        print(f"# pairs whose domains the float64 host engine gives: {json.dumps(agree)}",
              flush=True)


def main(argv):
    if argv[:1] == ["--one"]:
        time_tree(os.path.abspath(argv[1]))
        return
    if argv[:1] == ["--one-pair-domains"]:
        time_tree(os.path.abspath(argv[1]), pair_domains=True)
        return
    if argv[:1] == ["--one-domains"]:
        max_filter_domains(os.path.abspath(argv[1]), argv[2])
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if argv[:1] == ["--domains"]:
        compare_domains([os.path.abspath(tree) for tree in argv[1:] or [here]])
        return
    mode = "--one"
    if argv[:1] == ["--pair-domains"]:
        mode, argv = "--one-pair-domains", argv[1:]
    for tree in argv or [here]:
        subprocess.run([sys.executable, os.path.abspath(__file__), mode, tree], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])

#!/usr/bin/env python3
"""Numeric parity check of the PyTorch port's CUDA kernels on the card.

The twin of ``tools/tpu_check.py``: the same contracts, through the
compiled CUDA kernels of ``gecco_tpu_torch``, held against its plain
PyTorch versions and its float64 host engine.  It imports nothing but
``gecco_tpu_torch``.

Checks:

1. **minipfam fixture** — the reference GECCO's
   ``tests/test_hmmer/data/minipfam.hmm`` and ``proteins.faa``, found
   under ``$GECCO_REFERENCE``: ``backend="cuda"`` against
   ``backend="torch"`` (the same hit sets, envelope and alignment
   coordinates, scores within ``TOL_SCORE``), and the strong-hit set
   ``{PF10417, PF12574, PF00244}`` of the reference's contract.  Without
   the files it prints a skip that names the missing one.
2. **Viterbi** — on a synthetic bank (the multidomain workload's
   profiles and its first proteins): kernel H's Viterbi over every pair
   (``dense_scores(..., viterbi=True)``) and kernel B over the pairs
   listed (``viterbi_pairs``), each within 5e-3 nats of the float64
   ``engine.viterbi_score``.
3. **synthetic multi-domain workload** — proteins carrying 2-3 planted
   copies of one profile, built from the port's ``hmm.synthetic`` with
   the seeds of ``tools/tpu_check.py``: ``backend="cuda"`` against
   ``backend="torch"`` and against the float64 host path
   (``use_accelerator=False``); at least 4 multi-domain hits.

Usage: ``python3 tools/torch_check.py [--device cuda|cpu]`` (default
``cuda``; on ``cpu`` every kernel wrapper takes its plain version) —
prints one line per check and exits non-zero on any mismatch.
``chip_smoke.py`` runs it in-process (:func:`run`).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy

TOL_SCORE = 5e-3   # bits, sequence scores
TOL_BITS = 5e-2    # bits, per-domain
TOL_VITERBI = 5e-3  # nats, against the float64 engine
STRONG = {(0, "PF10417"), (1, "PF12574"), (2, "PF00244")}


class ParityError(AssertionError):
    pass


def _require(cond, msg):
    if not cond:
        raise ParityError(msg)


def _hit_key(h):
    return (h.sequence_index, h.profile.name)


def _compare_hits(got, want, label):
    _require(
        [_hit_key(h) for h in got] == [_hit_key(h) for h in want],
        f"{label}: reported hit sets differ: {[_hit_key(h) for h in got]} "
        f"vs {[_hit_key(h) for h in want]}",
    )
    for a, b in zip(got, want):
        _require(abs(a.score - b.score) < TOL_SCORE,
                 f"{label}: score mismatch {_hit_key(a)}: {a.score} vs {b.score}")
        _require(len(a.domains) == len(b.domains),
                 f"{label}: domain count mismatch {_hit_key(a)}: "
                 f"{len(a.domains)} vs {len(b.domains)}")
        for da, db in zip(a.domains, b.domains):
            coords_a = (da.ienv, da.jenv, da.target_from, da.target_to, da.hmm_from, da.hmm_to)
            coords_b = (db.ienv, db.jenv, db.target_from, db.target_to, db.hmm_from, db.hmm_to)
            _require(coords_a == coords_b,
                     f"{label}: envelope/alignment mismatch {_hit_key(a)}: "
                     f"{coords_a} vs {coords_b}")
            _require(abs(da.bitscore - db.bitscore) < TOL_BITS,
                     f"{label}: domain bitscore mismatch {_hit_key(a)}: "
                     f"{da.bitscore} vs {db.bitscore}")


def _fixture(name):
    root = os.environ.get("GECCO_REFERENCE")
    if not root:
        return None
    path = os.path.join(root, "tests", "test_hmmer", "data", name)
    return path if os.path.exists(path) else None


def check_minipfam(device):
    """The fixture database, kernels against plain PyTorch; None without it."""
    from gecco_tpu_torch import seqio
    from gecco_tpu_torch.hmm.io import encode_sequence, parse_hmmer3
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline
    from gecco_tpu_torch.hmm.profile import configure_many

    hmm, faa = _fixture("minipfam.hmm"), _fixture("proteins.faa")
    if hmm is None or faa is None:
        return None
    profiles = configure_many(parse_hmmer3(hmm))
    xs = [encode_sequence(str(r.seq)) for r in seqio.parse(faa)]
    cuda = SearchPipeline(profiles, device=device, Z=10, domZ=10, backend="cuda").search(xs)
    plain = SearchPipeline(profiles, device=device, Z=10, domZ=10, backend="torch").search(xs)
    _compare_hits(cuda, plain, "minipfam")
    strong = {(h.sequence_index, h.profile.accession.split(".")[0])
              for h in cuda if h.evalue < 1e-6}
    _require(strong == STRONG, f"minipfam: strong hit set {strong} != reference contract")
    return len(cuda)


def multidomain_workload(device):
    """``tools/tpu_check.py``'s multidomain workload, from the port's
    generators with the same seeds: 8 calibrated profiles, 12 proteins
    of up to 512 residues with 2-3 planted copies each."""
    from gecco_tpu_torch.hmm.calibrate import calibrate
    from gecco_tpu_torch.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins

    profiles = synthetic_profiles(8, min_length=30, max_length=70, seed=42)
    calibrate(profiles, device=device, n=200, L=160, seed=7)
    rng = numpy.random.default_rng(3)
    seqs = [x[:512] for x in synthetic_proteins(12, mean_length=420, seed=9)]
    for i in range(len(seqs)):
        gm = profiles[i % len(profiles)]
        copies = 2 + (i % 2)
        x = seqs[i]
        stride = max(gm.M + 20, len(x) // (copies + 1))
        for c in range(copies):
            off = 10 + c * stride
            if off + gm.M + 10 < len(x):
                x = plant_domain(x, gm, rng, offset=off, max_len=gm.M)
        seqs[i] = x
    return profiles, seqs


def check_multidomain(device, workload):
    """Kernels against plain PyTorch and against the float64 host path."""
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline

    profiles, seqs = workload
    cuda = SearchPipeline(profiles, device=device, Z=8, domZ=8, backend="cuda").search(seqs)
    plain = SearchPipeline(profiles, device=device, Z=8, domZ=8, backend="torch").search(seqs)
    host = SearchPipeline(profiles, device=device, Z=8, domZ=8,
                          use_accelerator=False).search(seqs)
    _compare_hits(cuda, plain, "multidomain/plain")
    _compare_hits(cuda, host, "multidomain/host")
    n_multi = sum(1 for h in cuda if len(h.domains) >= 2)
    _require(n_multi >= 4, f"multidomain: expected >=4 multi-domain hits, got {n_multi} "
                           "(workload no longer exercises envelope splitting)")
    return len(cuda), n_multi


def check_viterbi(device, workload, n_seqs=4):
    """Kernel H's dense Viterbi and kernel B's listed pairs against the
    float64 engine, on the workload's profiles and first proteins."""
    from gecco_tpu_torch.hmm import engine
    from gecco_tpu_torch.hmm.bank import TorchBank
    from gecco_tpu_torch.hmm.kernels import SeqPack, dense_scores, viterbi_pairs

    profiles, seqs = workload
    xs = seqs[:n_seqs]
    host = numpy.array([[engine.viterbi_score(gm, x) for gm in profiles] for x in xs])
    bank = TorchBank.build(profiles, device)
    pack = SeqPack(xs, device)
    full = dense_scores(pack, bank, viterbi=True).cpu().numpy()
    worst = float(numpy.abs(host - full).max())
    _require(worst < TOL_VITERBI, f"viterbi/dense (kernel H): max diff {worst} vs host")
    s_idx = numpy.repeat(numpy.arange(len(xs)), len(profiles))
    p_idx = numpy.tile(numpy.arange(len(profiles)), len(xs))
    pair = viterbi_pairs(pack, bank, s_idx, p_idx).cpu().numpy().reshape(host.shape)
    worst_pair = float(numpy.abs(host - pair).max())
    _require(worst_pair < TOL_VITERBI, f"viterbi/pairs (kernel B): max diff {worst_pair} vs host")
    return host.size, worst, worst_pair


def run(device="cuda", verbose=True):
    """Every check on ``device``; raises :class:`ParityError` on a mismatch."""
    import torch

    from gecco_tpu_torch._device import resolve_device

    device = resolve_device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    def say(line):
        if verbose:
            print(line, file=sys.stderr, flush=True)

    n1 = check_minipfam(device)
    if n1 is None:
        say("# parity minipfam: skipped (minipfam.hmm or proteins.faa not found under "
            "$GECCO_REFERENCE/tests/test_hmmer/data)")
    else:
        say(f"# parity minipfam: ok ({n1} hits, device={name})")
    workload = multidomain_workload(device)
    nv, worst, worst_pair = check_viterbi(device, workload)
    say(f"# parity viterbi: ok ({nv} pairs, kernel H {worst:.3g} and kernel B "
        f"{worst_pair:.3g} nats from the float64 engine, device={name})")
    n2, nm = check_multidomain(device, workload)
    say(f"# parity multidomain: ok ({n2} hits, {nm} multi-domain, device={name})")
    return name


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    try:
        name = run(args.device)
    except ParityError as exc:
        print(f"PARITY FAILURE: {exc}", file=sys.stderr)
        return 1
    print(f"parity: ok (device={name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The device-bound CLI steps of the port.

Everything else (loaders, writers, gene calling, refinement, typing) is
``gecco_tpu.cli.commands._common``'s own.
"""

import operator
from typing import Iterable, List

from gecco_tpu.cli.commands._common import _disentangle, custom_hmms, filter_domains
from gecco_tpu.profiling import timed

__all__ = ["annotate_domains", "predict_probabilities"]


@timed("annotate-domains")
def annotate_domains(
    logger, genes: List, *,
    hmm_paths: List, default_hmms: Iterable, device, backend: str = "cuda",
    whitelist=None, disentangle: bool = False, jobs: int = 0, bit_cutoffs=None,
    e_filter=None, p_filter=None,
) -> List:
    from ...hmm import ProfileHMMAnnotator

    logger.info("Running", f"profile-HMM domain annotation on {device}", level=1)
    hmms = list(custom_hmms(hmm_paths) if hmm_paths else default_hmms)
    if not hmms:
        raise RuntimeError(
            "no HMM libraries available: provide --hmm or install an "
            "embedded library (see `gecco_tpu.hmm.embedded_hmms`)"
        )
    for hmm in hmms:
        logger.info("Starting", f"annotation with {hmm.id} v{hmm.version}", level=2)
        genes = ProfileHMMAnnotator(
            hmm, jobs, whitelist, device=device, backend=backend,
        ).run(genes, bit_cutoffs=bit_cutoffs)
        logger.success("Finished", f"annotation with {hmm.id} v{hmm.version}", level=2)

    count = sum(len(gene.protein.domains) for gene in genes)
    logger.success("Found", count, "domains across all proteins", level=1)

    if disentangle:
        logger.info("Disentangling", "overlapping domains in each gene", level=1)
        genes = [_disentangle(gene) for gene in genes]

    genes = filter_domains(logger, genes, e_filter=e_filter, p_filter=p_filter)
    genes.sort(key=operator.attrgetter("source.id", "start", "end"))
    for gene in genes:
        gene.protein.domains.sort(key=operator.attrgetter("start", "end"))
    return genes


@timed("predict-probabilities")
def predict_probabilities(logger, genes: List, *, model, pad: bool, crf_type, device) -> List:
    if model is None:
        logger.info("Loading", "embedded CRF pre-trained model", level=1)
    else:
        logger.info("Loading", "CRF pre-trained model from", repr(str(model)), level=1)
    crf = crf_type.trained(model)
    logger.info("Predicting", "cluster probabilities with the model", level=1)
    return crf.predict_probabilities(genes, pad=pad, device=device)

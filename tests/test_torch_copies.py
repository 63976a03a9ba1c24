"""The port's own copies of the JAX package's parameters and data files.

The port keeps copies of the host modules and data it needs, so these
hold the copies equal to what the JAX package loads: profiles rebuilt
by ``profiles_from_arrays`` from a JAX profile's plain fields, the
embedded CRF weights, the frozen type forest and every data file.
"""

import filecmp
import os

import numpy
import pytest

from gecco_tpu.crf import ClusterCRF as JaxClusterCRF
from gecco_tpu.hmm.synthetic import pfam_shaped_profiles
from gecco_tpu.types import TypeClassifier as JaxTypeClassifier
from gecco_tpu.types.forest import Forest as JaxForest

from gecco_tpu_torch.crf import ClusterCRF
from gecco_tpu_torch.hmm.profile import profiles_from_arrays
from gecco_tpu_torch.hmm.synthetic import pfam_shaped_profiles as port_pfam_shaped_profiles
from gecco_tpu_torch.types import TypeClassifier
from gecco_tpu_torch.types.forest import Forest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_ARRAYS = ("msc", "tmm", "tim", "tdm", "tmi", "tii", "tmd", "tdd", "bm")


def test_profiles_from_arrays_equal_jax_profiles():
    jax_profiles = pfam_shaped_profiles(6, seed=3)
    jax_profiles[0].hmm.cutoffs = {"GA": (21.5, 20.0)}
    mine = profiles_from_arrays([vars(gm.hmm) for gm in jax_profiles])
    # the port's own generator gives the same profiles from the same seed
    generated = port_pfam_shaped_profiles(6, seed=3)
    for a, b, c in zip(mine, jax_profiles, generated):
        assert (a.name, a.accession, a.M) == (b.name, b.accession, b.M) == (c.name, c.accession, c.M)
        assert a.hmm.stats == b.hmm.stats and a.hmm.cutoffs == b.hmm.cutoffs
        assert (a.loop_e, a.move_e) == (b.loop_e, b.move_e)
        for name in PROFILE_ARRAYS:
            numpy.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            numpy.testing.assert_array_equal(getattr(c, name), getattr(b, name))
    # copies: calibrating the port's profiles leaves the JAX objects alone
    mine[1].hmm.stats["MSV"] = (0.0, 1.0)
    assert jax_profiles[1].hmm.stats["MSV"] != (0.0, 1.0)


def test_crf_weights_equal_jax_package():
    mine, theirs = ClusterCRF.trained(), JaxClusterCRF.trained()
    assert mine.attr_names == theirs.attr_names and mine.label_names == theirs.label_names
    assert (mine.feature_type, mine.window_size, mine.window_step) == (
        theirs.feature_type, theirs.window_size, theirs.window_step)
    numpy.testing.assert_array_equal(mine.state, theirs.state)
    numpy.testing.assert_array_equal(mine.trans, theirs.trans)
    assert mine.significance == theirs.significance


def test_forest_equal_jax_package():
    mine, theirs = Forest.load(), JaxForest.load()
    for name in ("children_left", "children_right", "feature", "threshold", "value",
                 "tree_offsets"):
        numpy.testing.assert_array_equal(getattr(mine, name), getattr(theirs, name))
    assert mine.classes == theirs.classes and mine.domains == theirs.domains
    assert TypeClassifier.trained().attributes_ == JaxTypeClassifier.trained().attributes_


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(ROOT, "gecco_tpu", "data"))))
def test_data_file_copied(name):
    assert filecmp.cmp(os.path.join(ROOT, "gecco_tpu", "data", name),
                       os.path.join(ROOT, "gecco_tpu_torch", "data", name), shallow=False)

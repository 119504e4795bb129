"""CPU tests of pisces_tpu_torch.kernel_ab, the A/B timing of kernel
versions: the source variants it builds replace whole functions of the
committed csrc and nothing else. Building and timing them needs nvcc and a
card (python -m pisces_tpu_torch.kernel_ab on the card)."""
import os

import pytest
import torch

from pisces_tpu_torch import kernel_ab as AB
from pisces_tpu_torch.ops import scoring_kernels as K


def _committed(name):
    with open(os.path.join(K._CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("signature", [AB.SPLIT_ROLES, AB.STAGE,
                                       AB.STAGE_WAIT])
def test_each_replaced_function_is_one_whole_function(signature):
    """The signature names one function of score_locus.cuh, and the span
    replace_function cuts out is that function, braces balanced."""
    hdr = _committed("score_locus.cuh")
    assert hdr.count(signature) == 1
    i = hdr.index(signature)
    cut = hdr[i:len(hdr) - len(AB.replace_function(hdr, signature, "")) + i]
    assert cut.endswith("\n}\n")
    assert cut.count("{") == cut.count("}") > 0


@pytest.mark.parametrize("name,gone,kept", [
    ("split", "cudaDevAttrMultiProcessorCount", "return true;"),
    ("thread", "cudaDevAttrMultiProcessorCount", "return false;"),
    ("loads", "cp.async.cg", "d[i] = __ldg(s + i);"),
    ("bulk", "cp.async.cg", "cp.async.bulk.shared::cluster"),
])
def test_variant_replaces_only_its_functions(name, gone, kept):
    src = AB.variant_sources(name)
    hdr = _committed("score_locus.cuh")
    assert gone in hdr and gone not in src["score_locus.cuh"]
    assert kept in src["score_locus.cuh"]
    funcs, init = AB.VARIANTS[name]
    # the header before the first replaced function is untouched
    first = min(hdr.index(sig) for sig in funcs)
    assert src["score_locus.cuh"][:first] == hdr[:first]
    for f in ("score_tuples.cu", "score_loci.cu"):
        ours = _committed(f)
        assert ours.count("  stage_wait();\n  __syncthreads();") == 1
        want = ours.replace("  stage(", "  stage_init();\n  stage(", 1) \
            if init else ours
        assert src[f] == want


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        AB.main([])

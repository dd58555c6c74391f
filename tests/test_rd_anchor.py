"""External RD anchor: MCTF must beat OpenJPEG-intra at matched rate on
temporally-redundant content.

The reference's whole purpose is RD performance (its evidence is the
``tests/RD-*.sh`` sweeps vs external codecs); this is the rebuild's
equivalent, with OpenJPEG (the Tier-1/Tier-2 interop oracle) coding the
same frames intra at the same byte budget.  This test pins the core claim
at one operating point per coder.
"""

import numpy as np
import pytest

from qsvc_tpu import api
from qsvc_tpu.config import CodecConfig
from qsvc_tpu.io import synthetic_video
from qsvc_tpu.scal import anchor, rd as rdmod

pytestmark = pytest.mark.skipif(not anchor.available(),
                                reason="Pillow built without OpenJPEG")


@pytest.fixture(scope="module")
def translating():
    cfg = CodecConfig(pixels_in_x=176, pixels_in_y=144, TRLs=3, GOPs=1,
                      block_size=16, search_range=4, SRLs=4,
                      quantization_texture=42000, nLayers=9,
                      update_factor=0.25)
    vid = synthetic_video(cfg.pictures, 144, 176, seed=5, kind="translate",
                          velocity=(1.0, 2.0))
    return cfg, vid


@pytest.mark.parametrize("coder,min_adv_db", [("mq", 2.0), ("bp", 0.5)])
def test_mctf_beats_intra_at_matched_rate(translating, coder, min_adv_db):
    cfg, vid = translating
    vs = api.compress(vid, cfg.replace(texture_coder=coder),
                      reversible=False)
    (pt,) = rdmod.rd_curve(vs, vid, [44500.0])
    n_opj, dec_opj, _ = anchor.match_rate(vid, pt.bytes)
    opj_psnr = anchor.psnr_y(vid, dec_opj)
    # matched-rate guard: the anchor may not be given a bigger budget
    assert n_opj <= pt.bytes * 1.05, (n_opj, pt.bytes)
    assert pt.psnr_y >= opj_psnr + min_adv_db, (
        f"MCTF {pt.psnr_y:.2f} dB at {pt.bytes} B vs OpenJPEG-intra "
        f"{opj_psnr:.2f} dB at {n_opj} B")


def test_subpixel_me_tracks_fractional_motion(translating):
    """Fractional global motion: sub-pixel ME must still beat intra at a
    mid rate (the reference's subpixel_accuracy machinery exists for
    exactly this content)."""
    cfg, _ = translating
    vid = synthetic_video(cfg.pictures, 144, 176, seed=7, kind="translate",
                          velocity=(1.5, 2.5))
    vs = api.compress(vid, cfg.replace(subpixel_accuracy=1,
                                       texture_coder="mq"),
                      reversible=False)
    (pt,) = rdmod.rd_curve(vs, vid, [44500.0])
    n_opj, dec_opj, _ = anchor.match_rate(vid, pt.bytes)
    assert n_opj <= pt.bytes * 1.05
    assert pt.psnr_y >= anchor.psnr_y(vid, dec_opj) + 1.0

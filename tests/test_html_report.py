"""HTML report content parity (VERDICT r2 weak #4 / item 6).

The reference renders web_summary.tpl.html from a root_dict contract
(longQC.py:689-831): stats table, optional adapter block, rl/rq/rc/gc/
fr/sc figure sections with stat tables, warn/error banners, pb/sequel
conditional notes. These tests render our template from synthetic
root_dicts and assert every block's CONTENT lands in the emitted file —
a regression that drops any stat row, banner, figure or conditional
panel fails here.
"""
import base64
import re
from collections import OrderedDict

import pytest

from longqc_tpu.report.html import render_report

PNG = base64.b64encode(b"\x89PNG fakepng").decode()


def _root(pb=False, sequel=False, with_ad=True, warns=None, errors=None):
    root = {
        "suffix": " - s1",
        "stats": OrderedDict([
            ("Sample name", "s1"),
            ("Yield", 123456),
            ("Number of reads", 42),
            ("Q7 bases", "88.123%"),
            ("Longest read", 9999),
            ("Estimated non-sense read fraction", "0.123"),
        ]),
        "rl": {"name": PNG, "stats": OrderedDict([
            ("Mean read length", "1500.123"), ("N50", "2000.456")])},
        "rq": {"name": PNG},
        "rc": {"cov_plot_name": PNG, "cov_over_len_plot_name": PNG,
               "cov_ovlp_qv_plot_name": PNG,
               "stats": OrderedDict([
                   ("Number of sampled reads", 40),
                   ("Mean per read coverage", "12.345"),
                   ("S.D. per read coverage", "3.210"),
                   ("Crude estimated Xome size", "1.2M")])},
        "gc": {"name": PNG, "stats": OrderedDict([
            ("Mean per read GC content", "41.000 %"),
            ("s.d. per read GC content", "2.500 %")])},
        "fr": {"name": PNG},
        "sc": {"name": PNG},
        "warns": warns or OrderedDict(),
        "errors": errors or OrderedDict(),
    }
    if with_ad:
        root["ad"] = OrderedDict([
            ("Number of trimmed reads in 5'", 7),
            ("Max seq identity for the adapter in 5'", "0.931"),
            ("Average trimmed length in 5'", "44.000")])
    if pb:
        root["pb"] = True
    if sequel:
        root["sequel"] = True
    return root


def _render(tmp_path, root):
    p = tmp_path / "r.html"
    render_report(root, str(p))
    return p.read_text()


def test_all_stats_rows_render(tmp_path):
    root = _root()
    html = _render(tmp_path, root)
    for section in ("stats", "ad"):
        for k, v in root[section].items():
            assert k in html, k
            assert str(v) in html, (k, v)
    for sub in ("rl", "rc", "gc"):
        for k, v in root[sub]["stats"].items():
            assert k in html, k
            assert str(v) in html, (k, v)
    assert "LongQC sample QC report" in html and " - s1" in html


def test_all_figures_embedded(tmp_path):
    html = _render(tmp_path, _root())
    # rl, rq, 3x rc, gc, fr, sc = 8 inlined figures
    assert html.count("data:image/png;base64," + PNG) == 8


def test_banners_render(tmp_path):
    warns = OrderedDict([("Low Q7", "This value should be higher.")])
    errors = OrderedDict([
        ("Too high non-sense read fraction", "Check the library."),
        ("Coverage estimation failure", "No coverage data exists.")])
    html = _render(tmp_path, _root(warns=warns, errors=errors))
    for k, v in list(warns.items()) + list(errors.items()):
        assert k in html and v in html
    assert html.count('class="banner warn"') == 1
    assert html.count('class="banner error"') == 2


def test_conditional_blocks(tmp_path):
    plain = _render(tmp_path, _root())
    assert "PacBio instruments trim adapters" not in plain
    assert "no per-base Phred" not in plain
    pb = _render(tmp_path, _root(pb=True))
    assert "PacBio instruments trim adapters" in pb
    seq = _render(tmp_path, _root(sequel=True))
    assert "no per-base Phred" in seq
    no_ad = _render(tmp_path, _root(with_ad=False))
    assert "Adapter statistics" not in no_ad
    no_rc = _root()
    del no_rc["rc"]
    html = _render(tmp_path, no_rc)
    assert "Per read coverage" not in html


def test_pipeline_emits_content(tmp_path):
    """End-to-end: the pipeline's real web_summary.html carries the
    JSON's stats values, not just an existing file."""
    import json
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    import numpy as np
    from util_synth import make_genome, sample_reads, write_fastq_file
    from longqc_tpu.engine.pipeline import run_sampleqc

    rng = np.random.RandomState(5)
    reads = sample_reads(rng, make_genome(rng, 9000), 50,
                         min_len=600, max_len=1500, err=0.1,
                         junk_frac=0.1)
    fq = tmp_path / "in.fq"
    write_fastq_file(str(fq), reads)
    out = tmp_path / "out"
    res = run_sampleqc(str(fq), str(out), "ont-ligation", nsample=30)
    html = (out / "web_summary.html").read_text()
    jd = json.load(open(out / "QC_vals_longQC_sampleqc.json"))
    assert str(jd["Yield"]) in html
    assert str(jd["Num_of_reads"]) in html
    assert "%.3f" % jd["Length_stats"]["N50_read_length"] in html
    assert "%.3f %%" % (100 * jd["GC_stats"]["Mean_GC_content"]) in html
    assert html.count("data:image/png;base64,") == 8
    # every row of the general stats table is non-empty
    cells = re.findall(r"<td>([^<]*)</td>", html)
    assert all(c.strip() for c in cells)

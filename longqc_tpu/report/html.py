"""Self-contained HTML report (jinja2, base64-inlined figures).

Same content contract as the reference web_summary template
(web_summary.tpl.html:342-698 rendered from the root_dict built in
longQC.py:689-831): general stats table, optional adapter block,
length/QV/coverage/GC/flanking/complexity sections with their figures
and stat tables, warning/error banners, and the platform-conditional
panels (the adapter panel carries a PacBio auto-trim note under `pb`;
the QV panel carries a no-Phred note under `sequel`). The markup,
styling and explanatory prose are an original design; content parity
is enforced by tests/test_html_report.py, which fails if any stats
key/value, banner, figure or conditional note goes missing.
"""

import base64

from jinja2 import Template

TEMPLATE = Template("""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>LongQC sample QC report{{ suffix }}</title>
<style>
 body { font-family: -apple-system, "Segoe UI", Helvetica, sans-serif;
        margin: 0; color: #222; background: #f6f7f9; }
 header { background: #123a5c; color: #fff; padding: 18px 32px; }
 header h1 { margin: 0; font-size: 22px; }
 .layout { display: flex; max-width: 1280px; margin: 0 auto; }
 nav { flex: 0 0 200px; padding: 24px 0 0 16px; }
 nav a { display: block; padding: 6px 10px; color: #123a5c;
         text-decoration: none; border-radius: 6px; font-size: 14px; }
 nav a:hover { background: #e2e8f0; }
 main { flex: 1; margin: 24px 16px; min-width: 0; }
 section { background: #fff; border-radius: 8px; padding: 20px 24px;
           margin-bottom: 20px; box-shadow: 0 1px 3px rgba(0,0,0,.08); }
 h2 { margin-top: 0; font-size: 18px; color: #123a5c; }
 p.note { color: #555; font-size: 13px; line-height: 1.5; }
 table.stats { border-collapse: collapse; min-width: 420px; }
 table.stats td { padding: 6px 14px; border-bottom: 1px solid #e4e7ea; }
 table.stats td:first-child { color: #555; }
 .banner { border-radius: 6px; padding: 10px 16px; margin: 8px 0; }
 .warn  { background: #fff6e0; border-left: 4px solid #e3a008; }
 .error { background: #fde8e8; border-left: 4px solid #c81e1e; }
 img { max-width: 100%; height: auto; }
 .figrow { display: flex; flex-wrap: wrap; gap: 16px; }
 .figrow > div { flex: 1 1 360px; }
 footer { text-align: center; color: #888; padding: 16px; font-size: 12px; }
</style>
</head>
<body>
<header><h1>LongQC &mdash; sample QC report{{ suffix }}</h1></header>
<div class="layout">
<nav>
 <a href="#stats">General statistics</a>
 {% if ad %}<a href="#adapter">Adapter statistics</a>{% endif %}
 <a href="#length">Read length</a>
 <a href="#quality">Per read QV</a>
 {% if rc %}<a href="#coverage">Per read coverage</a>{% endif %}
 <a href="#gc">GC contents</a>
 <a href="#flanking">Flanking region analysis</a>
 <a href="#complexity">Sequence complexity</a>
</nav>
<main>

{% if errors %}
<section id="errors">
 <h2>Errors</h2>
 {% for k, v in errors.items() %}
 <div class="banner error"><b>{{ k }}</b> &mdash; {{ v }}</div>
 {% endfor %}
</section>
{% endif %}
{% if warns %}
<section id="warnings">
 <h2>Warnings</h2>
 {% for k, v in warns.items() %}
 <div class="banner warn"><b>{{ k }}</b> &mdash; {{ v }}</div>
 {% endfor %}
</section>
{% endif %}

<section id="stats">
 <h2>General statistics</h2>
 <table class="stats">
 {% for k, v in stats.items() %}
  <tr><td>{{ k }}</td><td>{{ v }}</td></tr>
 {% endfor %}
 </table>
</section>

{% if ad %}
<section id="adapter">
 <h2>Adapter statistics</h2>
 {% if pb %}
 <p class="note">PacBio instruments trim adapters on-machine (the raw
 sequences live in bax.h5/scraps.bam), so hits here are usually
 residual and this panel is informational for PacBio runs.</p>
 {% endif %}
 <p class="note">A read counts as trimmed when an adapter-like match
 (identity &ge; 75%) occurs near either terminal. A surprisingly low
 count on an untrimmed library can indicate ligation problems.</p>
 <table class="stats">
 {% for k, v in ad.items() %}
  <tr><td>{{ k }}</td><td>{{ v }}</td></tr>
 {% endfor %}
 </table>
</section>
{% endif %}

<section id="length">
 <h2>Read length</h2>
 {% if rl.stats %}
 <table class="stats">
 {% for k, v in rl.stats.items() %}<tr><td>{{ k }}</td><td>{{ v }}</td></tr>{% endfor %}
 </table>
 {% endif %}
 <img src="data:image/png;base64,{{ rl.name }}" alt="read length">
</section>

<section id="quality">
 <h2>Per read QV</h2>
 {% if sequel %}
 <p class="note">Sequel data carries no per-base Phred scores, so the
 QV distribution cannot be computed for this run.</p>
 {% else %}
 <p class="note">Distribution of mean QV per read, binned by read
 length (the x axis is binned length, not position). Healthy runs show
 similar distributions for short and long reads, with medians above
 the Q7 threshold.</p>
 {% endif %}
 <img src="data:image/png;base64,{{ rq.name }}" alt="read quality">
</section>

{% if rc %}
<section id="coverage">
 <h2>Per read coverage</h2>
 <p class="note">Coverage statistics come from overlapping all reads
 against the subsample. A clean library shows a single coverage peak
 (detected by a GMM for genomes, or a Gaussian+lognormal mixture for
 transcriptomes); the middle plot checks for coverage fluctuation
 across read lengths, and the QV boxplot separates normal from
 non-sense reads &mdash; boxes close together suggest either very low
 coverage or a noisy dataset, so check the coverage plot alongside.
 Estimates here lean conservative: mapping against uncorrected reads
 is less sensitive, so the crude genome/transcriptome size tends to
 overshoot.</p>
 {% if rc.stats %}
 <table class="stats">
 {% for k, v in rc.stats.items() %}<tr><td>{{ k }}</td><td>{{ v }}</td></tr>{% endfor %}
 </table>
 {% endif %}
 <div class="figrow">
  <div><img src="data:image/png;base64,{{ rc.cov_plot_name }}" alt="coverage"></div>
  <div><img src="data:image/png;base64,{{ rc.cov_over_len_plot_name }}" alt="coverage over length"></div>
  <div><img src="data:image/png;base64,{{ rc.cov_ovlp_qv_plot_name }}" alt="qv by coverage"></div>
 </div>
</section>
{% endif %}

<section id="gc">
 <h2>GC contents</h2>
 <p class="note">Two distributions from the same data: whole-read GC
 (sharper, since long sequences average out) and 150 bp chunk GC
 (more robust across runs of the same sample, so comparable between
 replicates). Mean and standard deviation are listed even though GC
 content is not strictly Gaussian.</p>
 {% if gc.stats %}
 <table class="stats">
 {% for k, v in gc.stats.items() %}<tr><td>{{ k }}</td><td>{{ v }}</td></tr>{% endfor %}
 </table>
 {% endif %}
 <img src="data:image/png;base64,{{ gc.name }}" alt="gc fraction">
</section>

<section id="flanking">
 <h2>Flanking region analysis</h2>
 <p class="note">Unmapped flank lengths at the 5'/3' read terminals.
 Without artificial sequence the peak sits at 0; adapter-like content
 shows up as a characteristic offset, with the average trimmed length
 drawn as a dashed line when detected.</p>
 <img src="data:image/png;base64,{{ fr.name }}" alt="terminal analysis">
</section>

<section id="complexity">
 <h2>Sequence complexity</h2>
 <img src="data:image/png;base64,{{ sc.name }}" alt="masked fraction">
</section>

</main>
</div>
<footer>generated by longqc_tpu</footer>
</body>
</html>
""")


def enc_b64_str(file_path):
    with open(file_path, "rb") as f:
        return base64.b64encode(f.read()).decode("utf-8")


def render_report(root_dict, html_path):
    root = dict(root_dict)
    root.setdefault("suffix", "")
    html = TEMPLATE.render(**root)
    with open(html_path, "wb") as f:
        f.write(html.encode("utf-8"))

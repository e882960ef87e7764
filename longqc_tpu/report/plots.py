"""Report figures: length/gamma, QV-vs-length, masked fraction, GC.

Reproduces the reference's figure set (lq_gamma.plot_length_dist,
LqMask.plot_qscore_dist / plot_masked_fraction, LqGC.plot_unmasked_gc_frac),
drawn with the package's own PNG plotter (report/png).
"""

import numpy as np
from scipy.stats import gamma, gaussian_kde

from longqc_tpu.report.png import Figure


def rgb(r, g, b):
    return [r / 255, g / 255, b / 255]


def _binned_boxes(ax, values, lengths, interval):
    """Box per read-length bin (floor(length / interval)), labelled by
    the bin's start; returns the per-box bin ids."""
    bins = np.floor(np.asarray(lengths, float) / interval)
    ids = np.unique(bins[np.isfinite(bins)])
    vals = np.asarray(values, float)
    ax.boxplot([vals[bins == b] for b in ids])
    ax.xticks = (np.arange(1, len(ids) + 1),
                 [str(int(b * interval)) for b in ids])
    return ids


def plot_length_dist(fig_path, lengths, g_a, g_b, _max, _mean, _n50,
                     is_pb=False, b_width=1000):
    x = np.linspace(0, gamma.ppf(0.99, g_a, 0, g_b))
    est_dist = gamma(g_a, 0, g_b)
    red = rgb(214, 39, 40)
    fig = Figure()
    ax = fig.axes[0]
    ax.hist(lengths, bins=np.arange(min(lengths), _max + b_width, b_width),
            color=red, alpha=0.7, density=True, step=True)
    ax.grid(True)
    ax.xlabel = "Read length"
    ax.ylabel = "Probability density"
    ax.axvline(_mean, dashed=True, color=red, alpha=0.8)
    ax.axvline(_n50, color=red, alpha=0.8)
    xmax = gamma.ppf(0.99, g_a, 0, g_b)
    if not is_pb:
        ax.plot(x, est_dist.pdf(x), color=red)
    ax.set_xlim(0, xmax)
    ymax = ax.get_ylim()[1]
    if not is_pb:
        ax.text(xmax * 0.6, ymax * 0.72,
                "alpha=%.3f, beta=%.3f" % (g_a, g_b))
        ax.text(xmax * 0.6, ymax * 0.77, "Gamma dist params:")
    ax.text(xmax * 0.6, ymax * 0.85, "sample mean: %.3f" % (_mean,))
    ax.text(xmax * 0.6, ymax * 0.9, "N50: %.3f" % (_n50,))
    ax.text(_mean, ymax * 0.85, "Mean", color=red)
    ax.text(_n50, ymax * 0.9, "N50", color=red)
    fig.save(fig_path)


def plot_qscore_dist(df, column_qv, column_length, *, fp=None,
                     platform="ont", interval=3000):
    mid_threshold = 7 if platform == "ont" else 8
    n_bins = int(np.floor(np.nanmax(df[column_length].values) / interval))
    fig = Figure(width=max(640, 60 * (n_bins + 1)))
    ax = fig.axes[0]
    ax.grid(True)
    _binned_boxes(ax, df[column_qv].values, df[column_length].values,
                  interval)
    ymax = ax.get_ylim()[1]
    ax.axhspan(0, mid_threshold, "red", 0.1)
    ax.axhspan(mid_threshold, ymax, "green", 0.1)
    ax.set_ylim(0, ymax)
    ax.xlabel = "Binned read length"
    ax.ylabel = "Averaged QV"
    if fp:
        fig.save(fp)


def plot_masked_fraction(df_mask, fp=None):
    fig = Figure()
    ax = fig.axes[0]
    ax.grid(True)
    ax.hist(df_mask[3], alpha=0.2, bins=np.arange(0, 1.0, 0.01),
            color="red")
    ax.set_xlim(0, 1.0)
    ax.xlabel = "Low complexity fraction"
    ax.ylabel = "Frequency"
    if fp:
        fig.save(fp)


def plot_unmasked_gc_frac(gc_acc, fp=None, b_width=0.02):
    """-> [mean, sd] of per-read GC (cf. lq_gcfrac.py:49-85)."""
    r_frac = np.asarray(gc_acc.r_frac, float)
    c_frac = np.asarray(gc_acc.c_frac, float)
    rtn = [float(np.mean(r_frac)), float(np.std(r_frac))]
    fig = Figure()
    ax = fig.axes[0]
    ax.hist(r_frac, alpha=0.3,
            bins=np.arange(r_frac.min(), r_frac.max() + b_width, b_width),
            color="blue", density=True)
    dens_read = gaussian_kde(r_frac) if len(r_frac) > 1 else None
    if len(c_frac) > 1:
        ax.hist(c_frac, alpha=0.3,
                bins=np.arange(c_frac.min(), c_frac.max() + b_width,
                               b_width),
                color="red", density=True)
        dens_chunk = gaussian_kde(c_frac)
    else:
        dens_chunk = None
    ax.grid(True)
    xs = np.linspace(0, 1.0, 50)
    if dens_read is not None:
        ax.plot(xs, dens_read(xs), color="blue",
                label="GC fraction read")
    if dens_chunk is not None:
        ax.plot(xs, dens_chunk(xs), color="orange",
                label="GC fraction of chunked read (%dbp)"
                % gc_acc.chunk_size)
    ax.xlabel = "GC fraction"
    ax.ylabel = "Probability density"
    if fp:
        fig.save(fp)
    return rtn

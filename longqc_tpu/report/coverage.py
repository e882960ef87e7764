"""Coverage analytics over the 9-column per-read coverage table.

Equivalent of the reference's LqCoverage (lq_coverage.py:68-655):
non-sense-read fractions, deterministic 2-component GMM of per-read
coverage, Normal+LogNormal mixture for low-coverage/transcript data,
Poisson lambda bounds at high zero-coverage fraction, Xome-size
estimate, and the four coverage plots.
"""

import math
from logging import getLogger
from operator import itemgetter

import numpy as np
import pandas as pd
import scipy.stats as st
from scipy.signal import argrelmax

from longqc_tpu.ops.distfit import (fit_gmm, fit_norm_lognorm,
                                    gmm_score_samples)
from longqc_tpu.report.png import Figure

logger = getLogger(__name__)


class CoverageAnalytics:
    UNMAPPED_FRACTION_THRESHOLD = 0.4
    UNMAPPED_FRACTION_PARAM_MIN = 0.05
    UNMAPPED_FRACTION_PARAM_MAX = 0.2
    COV_CORRECTION = 0.9
    DIV_SCORE_THRESHOLD = 0.25
    COV_THRESHOLD_FOR_DIV_SC = 25
    LENGTH_BIN_THRESHOLD = 100
    # column indices (lq_coverage.py:77-85)
    READ_NAME, QLENGTH, N_MBASE = 0, 1, 2
    COV_CORS, MED_COV_CORS = 3, 4
    T1_COVERAGE, QV, DIV, COVERAGE = 5, 6, 7, 8

    def __init__(self, table_path_or_rows, is_transcript=False,
                 control_filtering=None):
        if isinstance(table_path_or_rows, (list, tuple)):
            from io import StringIO
            buf = StringIO("\n".join(table_path_or_rows) + "\n")
            self.df = pd.read_table(buf, sep="\t", header=None,
                                    dtype={3: str, 4: str})
        else:
            self.df = pd.read_table(table_path_or_rows, sep="\t",
                                    header=None, dtype={3: str, 4: str})
        self.min_lambda = None
        self.max_lambda = None
        self.unmapped_frac_trimmed = -1.0
        self.unmapped_frac_med = -1.0
        self.high_div_frac = -1.0
        self.model = None          # (weights, means, covs) tuple
        self.mean_main = None
        self.cov_main = None
        self.main_comp_index = None
        self.control_reads = None
        self.low_coverage = None
        self.no_coverage = None
        self.mix_model = None
        self.mode_logn_main = None
        self.mu_logn_main = None
        self.sigma_logn_main = None
        self.warnings = []
        self.errors = []
        self.is_transcript = is_transcript

        if control_filtering is not None:
            if isinstance(control_filtering, (list, tuple)):
                from io import StringIO
                buf = StringIO("\n".join(control_filtering) + "\n")
                dfc = pd.read_table(buf, sep="\t", header=None)
            else:
                dfc = pd.read_table(control_filtering, sep="\t", header=None)
            self.control_reads = dfc[dfc[self.T1_COVERAGE] >= 0.5][0].tolist()
            self.df = self.df[~self.df[self.READ_NAME].isin(
                self.control_reads)]

        self._est_coverage()

    # ------------------------------------------------------------------
    def get_mean(self):
        return self.mean_main

    def get_sd(self):
        return np.sqrt(self.cov_main) if self.cov_main else None

    def get_logn_mode(self):
        return self.mode_logn_main

    def get_logn_mu(self):
        return self.mu_logn_main

    def get_logn_sigma(self):
        return self.sigma_logn_main

    def get_expected_zero_rate(self):
        # empirical zero-coverage rate model (lq_coverage.py:151-158)
        if not self.mode_logn_main and not self.mean_main:
            return None
        if not self.mode_logn_main:
            return (self.mean_main, 1.3865 * 0.64086 ** self.mean_main)
        return (self.mode_logn_main, 1.3865 * 0.64086 ** self.mode_logn_main)

    def get_unmapped_frac(self):
        return self.unmapped_frac_trimmed

    def get_unmapped_med_frac(self):
        return self.unmapped_frac_med

    def is_no_coverage(self):
        return self.no_coverage

    def is_low_coverage(self):
        return self.low_coverage

    def get_high_div_frac(self):
        return self.high_div_frac

    def get_control_num(self):
        return len(self.control_reads) if self.control_reads else 0.0

    def get_control_frac(self):
        if self.control_reads:
            return len(self.control_reads) / (len(self.control_reads)
                                              + len(self.df))
        return 0.0

    def get_errors(self):
        return self.errors

    def get_warnings(self):
        return self.warnings

    # ------------------------------------------------------------------
    def _est_coverage(self):
        df = self.df
        n = df.shape[0]
        self.unmapped_frac_trimmed = float(
            (df[self.T1_COVERAGE] == 0.0).sum()) / n
        self.unmapped_frac_med = float(
            (df[self.MED_COV_CORS] == "0").sum()) / n
        self.high_div_frac = float(
            ((df[self.DIV] >= self.DIV_SCORE_THRESHOLD)
             & (df[self.T1_COVERAGE] >= self.COV_THRESHOLD_FOR_DIV_SC)
             & (df[self.MED_COV_CORS] != "0")).sum()) / n

        model = self._est_coverage_dist_gmm()
        self.model, self.mean_main, self.cov_main, self.main_comp_index = model

        # low-coverage shape detection via the raw per-base coverage
        # histogram (lq_coverage.py:234-243,287-295)
        ratio = (df[self.N_MBASE] / df[self.QLENGTH]).to_numpy(float)
        bins = np.arange(0, self.mean_main + 10 * np.sqrt(self.cov_main)
                         + self.mean_main / 10, self.mean_main / 10)
        hist, _ = np.histogram(ratio, bins=bins, density=True)
        self.low_coverage = self._looks_lowcoverage(hist)

        if self.unmapped_frac_med >= self.UNMAPPED_FRACTION_THRESHOLD:
            self.min_lambda = -1 * math.log(
                self.unmapped_frac_med - self.UNMAPPED_FRACTION_PARAM_MIN)
            self.max_lambda = -1 * math.log(
                self.unmapped_frac_med - self.UNMAPPED_FRACTION_PARAM_MAX)

        if self.model is None:
            self.low_coverage = None
            self.no_coverage = True
            logger.warning("No coverage data is available.")
            return

        if (self.low_coverage and not self.is_transcript):
            self._est_coverage_dist_lognorm_norm()
            self.mode_logn_main = float(np.exp(
                self.mix_model[1][1] - self.mix_model[2][1] ** 2))
            self.mu_logn_main = self.mix_model[1][1]
            self.sigma_logn_main = self.mix_model[2][1]

        if self.is_transcript:
            self._est_coverage_dist_lognorm_norm()
            self.mode_logn_main = float(np.exp(
                self.mix_model[1][1] - self.mix_model[2][1] ** 2 * 0.5))
            self.mu_logn_main = self.mix_model[1][1]
            self.sigma_logn_main = self.mix_model[2][1]

    def _looks_lowcoverage(self, hist):
        if len(hist) == 0 or hist.sum() == 0:
            return True
        relmaxs = argrelmax(hist)
        if hist[0] / np.sum(hist) < 0.01:
            return False
        for mx_i in relmaxs[0]:
            if hist[mx_i] > (hist[0] / 5):
                return False
        return True

    def _nonzero_below_quantile(self):
        th = self.df[self.COVERAGE].quantile(0.85)
        if th == 0.0:
            th = self.df[self.COVERAGE].quantile(1.0)
        vals = self.df[self.COVERAGE].to_numpy(float)
        nz = vals[vals.nonzero()]
        return nz[nz < th]

    def _est_coverage_dist_gmm(self, k=2):
        data = self._nonzero_below_quantile()
        if data.size == 0:
            return (None, 1, 10, 0)
        weights, means, covs = fit_gmm(data, n_comp=k)
        order = weights / covs
        c_i = int(np.argmax(order))
        return ((weights, means, covs), float(means[c_i]),
                float(covs[c_i]), c_i)

    def _est_coverage_dist_lognorm_norm(self):
        data = self._nonzero_below_quantile()
        weights, means, covs = self.model
        i_bg = 0 if self.main_comp_index == 1 else 1
        i_m = 1 if self.main_comp_index == 1 else 0
        w, mus, sigmas = fit_norm_lognorm(
            data, means[i_bg], np.sqrt(covs[i_bg]),
            np.log(means[i_m]), 1.0)
        self.mix_model = (w, mus, sigmas)

    # ------------------------------------------------------------------
    def calc_xome_size(self, throughput):
        if self.no_coverage:
            return "N/A"
        if self.is_transcript or self.low_coverage:
            m_size = int((throughput * (1.0 - self.unmapped_frac_med))
                         / self.mode_logn_main)
        else:
            m_size = int((throughput * (1.0 - self.unmapped_frac_med))
                         / self.mean_main)
        if self.unmapped_frac_med >= self.UNMAPPED_FRACTION_THRESHOLD:
            _s1 = (throughput * self.COV_CORRECTION
                   * (1 - self.UNMAPPED_FRACTION_PARAM_MIN) / self.min_lambda)
            _s2 = (throughput * self.COV_CORRECTION
                   * (1 - self.UNMAPPED_FRACTION_PARAM_MAX) / self.max_lambda)
            return "%d (e = %.1f%%), %d (e = 20%%), %d (e = 5%%)" % (
                m_size, self.unmapped_frac_med * 100, _s2, _s1)
        return "%d (e = %.1f%%)" % (m_size, self.unmapped_frac_med * 100)

    # ------------------------------------------------------------------
    # plots

    def plot_coverage_dist(self, fp=None):
        if self.min_lambda and self.max_lambda:
            fig = Figure(width=1200, height=500, ncols=2)
            ax = fig.axes[0]
            ax.grid(True)
            pois_x = np.arange(int(self.mean_main
                                   + 4 * np.sqrt(self.cov_main)) + 1)
            ax.plot(pois_x, st.poisson(self.min_lambda).pmf(pois_x),
                    label="Fitted Model by Poisson model (%.3f)"
                    % self.min_lambda)
            ax.plot(pois_x, st.poisson(self.max_lambda).pmf(pois_x),
                    label="Fitted Model by Poisson model (%.3f)"
                    % self.max_lambda)
            ax.set_xlim(0, 50)
            ax.xlabel = "Per read coverage"
            ax.ylabel = "Probability density"
            self._cov_hist(ax)
            ax = fig.axes[1]
        else:
            fig = Figure()
            ax = fig.axes[0]
        ax.grid(True)

        gmm_x = np.linspace(0, self.mean_main
                            + 10 * np.sqrt(self.cov_main), 5000)
        if self.mix_model is not None:
            w, mus, sigmas = self.mix_model
            mix_y = (w[0] * st.norm(mus[0], sigmas[0]).pdf(gmm_x)
                     + w[1] * st.lognorm.pdf(gmm_x, sigmas[1], loc=0,
                                             scale=np.exp(mus[1])))
            ax.plot(gmm_x, mix_y,
                    label="Fitted by Lognormal and gaussian mixture model")
            ax.set_xlim(0, gmm_x[-1])
        elif self.model is None:
            fig.note(0.30, 0.5, "Caution: coverage estimation was "
                     "skipped due to insufficient amount of data.")
        else:
            weights, means, covs = self.model
            gmm_y = np.exp(gmm_score_samples(gmm_x, weights, means, covs))
            ax.plot(gmm_x, gmm_y, label="Fitted by Gaussian mixture model")
            ax.set_xlim(0, gmm_x[-1])
        self._cov_hist(ax)
        ax.xlabel = "Per read coverage"
        ax.ylabel = "Probability density"
        if fp:
            fig.save(fp)

    def _cov_hist(self, ax):
        ax.hist(self.df[self.COVERAGE],
                alpha=0.2,
                bins=np.arange(0, self.mean_main
                               + 10 * np.sqrt(self.cov_main)
                               + self.mean_main / 10,
                               self.mean_main / 10),
                color="green", density=True)

    def _region_analysis(self):
        """Parse coords column -> 5'/3' distances + internal gaps
        (lq_coverage.py:623-655)."""
        trim_5, trim_3, intrnl = [], [], []
        for i in self.df.index.tolist():
            sv = self.df[self.COV_CORS][i]
            if sv == "0":
                continue
            ql = self.df[self.QLENGTH][i]
            regs = [(int(r.split("-")[0]), int(r.split("-")[1]))
                    for r in sv.split(",")]
            if len(regs) > 1:
                sr = sorted(regs, key=itemgetter(0, 1))
                s, e = sr[0][0], sr[-1][1]
                for kk in range(len(regs) - 1):
                    intrnl.append(regs[kk + 1][0] - regs[kk][1])
            elif len(regs) == 1:
                s, e = regs[0]
            else:
                continue
            trim_5.append(s)
            trim_3.append(int(ql) - int(e))
        return trim_5, trim_3, intrnl

    def plot_unmapped_frac_terminal(self, fp=None, *, adp5_pos=None,
                                    adp3_pos=None, x_max=145):
        fig = Figure(width=1200, height=500, ncols=2)
        ax1, ax2 = fig.axes
        t5l, t3l, _ = self._region_analysis()
        ax1.hist(t5l, alpha=0.2, bins=np.arange(0, x_max, 5),
                 color="green")
        ax1.set_xlim(0, x_max)
        ax1.xlabel = "Distance from 5' terminal"
        ax1.ylabel = "Frequency"
        ax2.hist(t3l, alpha=0.2, bins=np.arange(0, x_max, 5),
                 color="orange")
        ax2.set_xlim(x_max, 0)
        ax2.xlabel = "Distance from 3' terminal"
        ax2.ylabel = "Frequency"
        ymax = max(ax1.get_ylim()[1], ax2.get_ylim()[1])
        ax1.set_ylim(0, ymax)
        ax2.set_ylim(0, ymax)
        if adp5_pos:
            ax1.axvline(adp5_pos, dashed=True, color="red", alpha=0.8)
            ax1.text(adp5_pos, ymax * 0.85, "Length of the adapter",
                     anchor="right" if adp5_pos > 90 else "left")
        if adp3_pos:
            ax2.axvline(adp3_pos, dashed=True, color="red", alpha=0.8)
            ax2.text(adp3_pos, ymax * 0.85, "Length of the adapter",
                     anchor="left" if adp3_pos > 90 else "right")
        if fp:
            fig.save(fp)

    def plot_qscore_dist(self, fp=None, *, platform="ont"):
        mid_threshold = 7
        fig = Figure()
        ax = fig.axes[0]
        ax.grid(True)
        qv = self.df[self.QV].to_numpy(float)
        cov = self.df[self.COVERAGE].to_numpy(float)
        ax.boxplot([qv[cov == 0.0], qv[cov != 0.0]])
        ax.xticks = ([1, 2], ["Non-sense reads", "Normal reads"])
        ymax = ax.get_ylim()[1]
        ax.axhspan(0, mid_threshold, "red", 0.1)
        ax.axhspan(mid_threshold, ymax, "green", 0.1)
        ax.set_ylim(0, ymax)
        ax.ylabel = "Averaged QV"
        if fp:
            fig.save(fp)

    def plot_length_vs_coverage(self, fp=None, *, interval=3000.0):
        df = self.df
        df.loc[df[self.QLENGTH] >= 3000, "MERGED_COVERAGE"] = \
            df[self.COVERAGE]
        df.loc[df[self.QLENGTH] < 3000, "MERGED_COVERAGE"] = \
            df[self.T1_COVERAGE]
        df["Binned read length"] = np.floor(
            df[self.QLENGTH].to_numpy(float) / interval)
        n_bins = int(df["Binned read length"].max())
        fig = Figure(width=max(640, 60 * (n_bins + 1)))
        ax = fig.axes[0]
        ids = np.unique(df["Binned read length"].to_numpy(float))
        mc = df["MERGED_COVERAGE"].to_numpy(float)
        bl = df["Binned read length"].to_numpy(float)
        ax.boxplot([mc[bl == b] for b in ids])
        ax.xticks = (np.arange(1, len(ids) + 1),
                     [str(int(b * interval)) for b in ids])
        bin_size = df.groupby("Binned read length").size()
        reliable = np.where(bin_size >= self.LENGTH_BIN_THRESHOLD)[0]
        xmin, xmax = ax.get_xlim()
        if reliable.size > 0:
            dmin, dmax = reliable.min(), reliable.max()
            if dmax < xmax:
                ax.axvspan(dmax + 1.5, xmax + 1, "gray", 0.1)
            if dmin > xmin:
                ax.axvspan(xmin - 1, dmin + 1.5, "gray", 0.1)
        else:
            ax.axvspan(xmin - 1, xmax + 1, "gray", 0.1)
        ax.title = "Read coverage over different length reads"
        ax.set_ylim(0, self.mean_main + 20 * np.sqrt(self.cov_main))
        ax.ylabel = "per-read coverage"
        if (not self.min_lambda and not self.max_lambda
                and self.mix_model is None):
            yc = self.get_mean() - 3 * self.get_sd()
            ax.axhline(yc, color="royalblue", alpha=0.4)
            ax.text(xmin, yc, "3 sigma", color="royalblue")
            yc = self.get_mean() + 3 * self.get_sd()
            ax.axhline(yc, color="royalblue", alpha=0.4)
            ax.text(xmin, yc, "3 sigma", color="royalblue")
            self._check_outlier_coverage()
        if fp:
            fig.save(fp)

    def _check_outlier_coverage(self):
        stats = self.df.groupby("Binned read length")[self.COVERAGE].agg(
            ["median", "size"])
        meds = stats["median"].iloc[
            np.where(stats["size"] >= self.LENGTH_BIN_THRESHOLD)[0]]
        three_sigma = np.where(
            (meds > self.get_mean() + 3 * self.get_sd())
            | (meds <= self.get_mean() - 3 * self.get_sd()))
        if len(three_sigma[0]) > 0:
            self.warnings.append(
                ("Coverage warning",
                 "Coverage might not be homogenous over the read length."))

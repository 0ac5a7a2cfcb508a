// Native assignment solver for the host-side tracker.
//
// Reference parity: the reference solves its per-frame-pair bipartite
// matching with scipy's Hungarian (SURVEY.md §3.3). This is the tracker's
// innermost host loop, so the TPU rebuild ships it native: an O(n^3)
// shortest-augmenting-path (Jonker-Volgenant style) solver on row-major
// double matrices, exposed with a C ABI for ctypes. Also exposes a greedy
// solver and a batched IoU cost-matrix builder so a whole video's linking
// never leaves C++.
//
// The port's copy of native/hungarian.cpp. Built at first use by
// kernels/_build.py (g++ -O3 -shared -fPIC) and loaded by tracking/native.py.

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {
constexpr double kInf = std::numeric_limits<double>::infinity();
}

extern "C" {

// Minimum-cost assignment on an n_rows x n_cols matrix (row-major).
// Writes row_to_col[i] = matched column or -1. Entries >= big are treated
// as forbidden (never matched in the returned solution).
//
// Classical Jonker-Volgenant shortest augmenting path, O(n^3), on the
// square matrix obtained by padding with a uniform huge-but-finite cost so
// every augmentation completes; pad and forbidden matches are dropped at
// readout. The pad value dominates any sum of real edges, so the solution
// restricted to real edges is optimal among matchings of maximum real
// cardinality — the same convention scipy's linear_sum_assignment yields on
// a big-value-capped matrix.
void solve_assignment_f64(const double* cost, int n_rows, int n_cols,
                          double big, int32_t* row_to_col) {
  const int n = n_rows > n_cols ? n_rows : n_cols;
  const double pad = big * (double)(n + 1);

  auto at = [&](int i, int j) -> double {
    if (i >= n_rows || j >= n_cols) return pad;
    const double v = cost[(size_t)i * n_cols + j];
    return v >= big ? pad : v;
  };

  // 1-based; match_col[j] = row matched to column j (0 = none).
  std::vector<int> match_col(n + 1, 0);
  std::vector<double> pot_row(n + 1, 0.0), pot_col(n + 1, 0.0);
  std::vector<double> min_slack(n + 1);
  std::vector<int> slack_arg(n + 1);
  std::vector<char> visited(n + 1);

  for (int i = 1; i <= n; ++i) {
    int j0 = 0;
    match_col[0] = i;
    std::fill(min_slack.begin(), min_slack.end(), kInf);
    std::fill(visited.begin(), visited.end(), 0);
    do {
      visited[j0] = 1;
      const int i0 = match_col[j0];
      double delta = kInf;
      int j1 = 0;
      for (int j = 1; j <= n; ++j) {
        if (visited[j]) continue;
        const double red = at(i0 - 1, j - 1) - pot_row[i0] - pot_col[j];
        if (red < min_slack[j]) {
          min_slack[j] = red;
          slack_arg[j] = j0;
        }
        if (min_slack[j] < delta) {
          delta = min_slack[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= n; ++j) {
        if (visited[j]) {
          pot_row[match_col[j]] += delta;
          pot_col[j] -= delta;
        } else {
          min_slack[j] -= delta;
        }
      }
      j0 = j1;
    } while (match_col[j0] != 0);
    // Augment along the alternating path back to the virtual column 0.
    while (j0 != 0) {
      const int j_prev = slack_arg[j0];
      match_col[j0] = match_col[j_prev];
      j0 = j_prev;
    }
    match_col[0] = 0;
  }

  for (int i = 0; i < n_rows; ++i) row_to_col[i] = -1;
  for (int j = 1; j <= n; ++j) {
    const int i = match_col[j];
    if (i > 0 && i <= n_rows && j <= n_cols
        && cost[(size_t)(i - 1) * n_cols + (j - 1)] < big) {
      row_to_col[i - 1] = j - 1;
    }
  }
}

// Greedy globally-smallest-first matching (reference's ablation option).
void solve_greedy_f64(const double* cost, int n_rows, int n_cols,
                      double big, int32_t* row_to_col) {
  std::vector<char> row_used(n_rows, 0), col_used(n_cols, 0);
  for (int i = 0; i < n_rows; ++i) row_to_col[i] = -1;
  const int k = n_rows < n_cols ? n_rows : n_cols;
  for (int it = 0; it < k; ++it) {
    double best = kInf;
    int bi = -1, bj = -1;
    for (int i = 0; i < n_rows; ++i) {
      if (row_used[i]) continue;
      const double* row = cost + (size_t)i * n_cols;
      for (int j = 0; j < n_cols; ++j) {
        if (col_used[j] || row[j] >= big) continue;
        if (row[j] < best) { best = row[j]; bi = i; bj = j; }
      }
    }
    if (bi < 0) break;
    row_used[bi] = 1;
    col_used[bj] = 1;
    row_to_col[bi] = bj;
  }
}

// IoU *distance* (1 - IoU) matrix between (p, 4) and (c, 4) x1y1x2y2 boxes
// with the Detectron +1 convention — the tracker's bbox-iou metric.
void iou_cost_matrix_f64(const double* prev, int p, const double* cur, int c,
                         double* out) {
  for (int i = 0; i < p; ++i) {
    const double px1 = prev[i * 4], py1 = prev[i * 4 + 1];
    const double px2 = prev[i * 4 + 2], py2 = prev[i * 4 + 3];
    const double pa = (px2 - px1 + 1.0) * (py2 - py1 + 1.0);
    for (int j = 0; j < c; ++j) {
      const double cx1 = cur[j * 4], cy1 = cur[j * 4 + 1];
      const double cx2 = cur[j * 4 + 2], cy2 = cur[j * 4 + 3];
      const double iw = std::fmin(px2, cx2) - std::fmax(px1, cx1) + 1.0;
      const double ih = std::fmin(py2, cy2) - std::fmax(py1, cy1) + 1.0;
      double iou = 0.0;
      if (iw > 0.0 && ih > 0.0) {
        const double inter = iw * ih;
        const double ca = (cx2 - cx1 + 1.0) * (cy2 - cy1 + 1.0);
        iou = inter / (pa + ca - inter);
      }
      out[(size_t)i * c + j] = 1.0 - iou;
    }
  }
}

}  // extern "C"

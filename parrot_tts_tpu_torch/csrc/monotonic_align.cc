// Monotonic shortest-path duration extraction; the port's copy of the JAX
// package's native/monotonic_align.cc, built with g++ by
// ops/monotonic_align.py at first use.
//
// The reference builds a sparse (M*N)^2 adjacency matrix and runs scipy's
// Dijkstra (utils/aligner/duration_extraction.py:14-85). The graph is a
// DAG with only right / down / down-right moves, so the shortest path is
// an O(M*N) dynamic program. Sums are in double; ties resolve down, then
// diagonal, then right; per mel row the LAST token visited wins (the
// reference's dict overwrite, duration_extraction.py:74-84).
//
// monotonic_duration_margin also returns the gap between the best path's
// cost and the second best's: the least, over the best path's nodes, of
// (cost of the best other predecessor) - (cost of the chosen one). A path
// that differs from the best one enters it for the last time at some node
// from another predecessor, so no other path is cheaper than best + gap.

#include <cstddef>
#include <cstdint>
#include <limits>
#include <utility>
#include <vector>

using std::size_t;

namespace {

void duration_dp(const float* cost, int rows, int cols, int32_t* durations,
                 double* margin) {
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> prev(cols, INF), cur(cols, INF);
  // moves: 0=right (i, j-1 -> i, j), 1=down (i-1, j), 2=diag (i-1, j-1)
  std::vector<uint8_t> choice(static_cast<size_t>(rows) * cols, 0);
  std::vector<double> gap;
  if (margin) gap.assign(static_cast<size_t>(rows) * cols, INF);

  prev[0] = 0.0;  // start node (0, 0), its cost excluded
  for (int j = 1; j < cols; ++j) prev[j] = prev[j - 1] + cost[j];  // right
  for (int i = 1; i < rows; ++i) {
    const float* crow = cost + static_cast<size_t>(i) * cols;
    uint8_t* chrow = choice.data() + static_cast<size_t>(i) * cols;
    for (int j = 0; j < cols; ++j) {
      double best = prev[j];  // down
      uint8_t ch = 1;
      double second = INF;
      if (j > 0) {
        const double diag = prev[j - 1], right = cur[j - 1];
        if (diag < best) { second = best; best = diag; ch = 2; }
        else second = diag;
        if (right < best) { second = best; best = right; ch = 0; }
        else if (right < second) second = right;
      }
      cur[j] = best + crow[j];
      chrow[j] = ch;
      if (margin) gap[static_cast<size_t>(i) * cols + j] = second - best;
    }
    std::swap(prev, cur);
  }

  std::vector<int32_t> row_token(rows, -1);
  double least = INF;
  int i = rows - 1, j = cols - 1;
  while (true) {
    // the first visit of a row walking back is the last walking forward
    if (row_token[i] < 0) row_token[i] = j;
    if (margin && gap[static_cast<size_t>(i) * cols + j] < least)
      least = gap[static_cast<size_t>(i) * cols + j];
    if (i == 0 && j == 0) break;
    switch (choice[static_cast<size_t>(i) * cols + j]) {
      case 0: j -= 1; break;
      case 1: i -= 1; break;
      default: i -= 1; j -= 1; break;
    }
  }
  for (int jj = 0; jj < cols; ++jj) durations[jj] = 0;
  for (int ii = 0; ii < rows; ++ii) durations[row_token[ii]] += 1;
  if (margin) *margin = least;
}

}  // namespace

extern "C" {

// cost: (rows x cols) row-major = 1 - posterior (the entering node's edge
// weight; cost[0][0] is the start node and is not counted).
// durations: (cols,) out, frames assigned per token column.
void monotonic_duration(const float* cost, int rows, int cols,
                        int32_t* durations) {
  duration_dp(cost, rows, cols, durations, nullptr);
}

void monotonic_duration_margin(const float* cost, int rows, int cols,
                               int32_t* durations, double* margin) {
  duration_dp(cost, rows, cols, durations, margin);
}

}  // extern "C"

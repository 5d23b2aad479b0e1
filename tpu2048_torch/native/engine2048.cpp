// Host-side native engine for tpu2048 (a copy of
// tpu2048/native/engine2048.cpp: the same code, comments aside).
//
// The device path owns bulk compute; this C++ module owns
// the latency-sensitive HOST loops around it: interactive play, live
// watch, game replay, and deep expectimax for a single board — the
// paths where the reference spent ~1 s/move in recursive Python
// (abachurin/2048, game2048/game_logic.py:214-243, README.md:145).
//
// Semantics mirror tpu2048/engine/lut.py exactly (slide, pairwise
// leftmost-first merge, no chain merges, score = value of created
// tiles) and the reference's look_forward: sample min(width, empty)
// distinct empty cells, tile 2 w.p. 0.9 else 4, max over legal moves
// of the recursive value, -100 for dead boards, max(best, 0) per
// child, prune (return the raw estimate) when empty >= since_empty.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libengine2048.so
// Exposed via ctypes (see tpu2048/native/__init__.py); plain C ABI.

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

uint16_t L_CELLS[65536][4];  // resulting row exponents (slide-left)
int32_t L_SCORE[65536];
uint8_t L_CHANGED[65536];
bool LUT_READY = false;

inline uint32_t pack_row(const int8_t r[4]) {
  return (uint32_t(r[0]) << 12) | (uint32_t(r[1]) << 8) |
         (uint32_t(r[2]) << 4) | uint32_t(r[3]);
}

void build_luts_impl() {
  for (uint32_t code = 0; code < 65536u; ++code) {
    int v[4] = {int(code >> 12) & 0xF, int(code >> 8) & 0xF,
                int(code >> 4) & 0xF, int(code) & 0xF};
    int out[4] = {0, 0, 0, 0};
    int k = 0;
    for (int i = 0; i < 4; ++i)
      if (v[i]) out[k++] = v[i];
    int32_t score = 0;
    for (int i = 0; i < 3; ++i) {
      if (out[i] && out[i] == out[i + 1]) {
        out[i] += 1;
        out[i + 1] = 0;
        score += int32_t(1) << out[i];
      }
    }
    int out2[4] = {0, 0, 0, 0};
    k = 0;
    for (int i = 0; i < 4; ++i)
      if (out[i]) out2[k++] = out[i];
    bool changed = false;
    for (int i = 0; i < 4; ++i) {
      L_CELLS[code][i] = uint16_t(out2[i]);
      if (out2[i] != v[i]) changed = true;
    }
    L_SCORE[code] = score;
    L_CHANGED[code] = changed ? 1 : 0;
  }
  LUT_READY = true;
}

// xorshift32 — deterministic, seedable host RNG (independent of the
// device PRNG; host games carry their own seed).
inline uint32_t xorshift32(uint32_t* s) {
  uint32_t x = *s;
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  *s = x ? x : 0x9E3779B9u;
  return *s;
}

inline double uniform01(uint32_t* s) {
  return double(xorshift32(s)) / 4294967296.0;
}

// Apply slide-left semantics along an axis of the 4x4 board.
// dir: 0=left, 1=up, 2=right, 3=down (reference encoding,
// game_logic.py:136-142 via rot90).
int32_t apply_move_impl(int8_t* b, int dir, bool* changed_out) {
  int32_t delta = 0;
  bool changed = false;
  for (int j = 0; j < 4; ++j) {
    int8_t line[4];
    // gather the j-th row/column in move order
    for (int i = 0; i < 4; ++i) {
      int cell;
      switch (dir) {
        case 0: cell = j * 4 + i; break;          // left: row fwd
        case 2: cell = j * 4 + (3 - i); break;    // right: row rev
        case 1: cell = i * 4 + j; break;          // up: col fwd
        default: cell = (3 - i) * 4 + j; break;   // down: col rev
      }
      line[i] = b[cell];
    }
    uint32_t code = pack_row(line);
    if (L_CHANGED[code]) changed = true;
    delta += L_SCORE[code];
    const uint16_t* out = L_CELLS[code];
    for (int i = 0; i < 4; ++i) {
      int cell;
      switch (dir) {
        case 0: cell = j * 4 + i; break;
        case 2: cell = j * 4 + (3 - i); break;
        case 1: cell = i * 4 + j; break;
        default: cell = (3 - i) * 4 + j; break;
      }
      b[cell] = int8_t(out[i]);
    }
  }
  if (changed_out) *changed_out = changed;
  return delta;
}

int count_empty_impl(const int8_t* b) {
  int n = 0;
  for (int i = 0; i < 16; ++i)
    if (!b[i]) ++n;
  return n;
}

bool game_over_impl(const int8_t* b) {
  for (int i = 0; i < 16; ++i)
    if (!b[i]) return false;
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 3; ++c)
      if (b[r * 4 + c] == b[r * 4 + c + 1]) return false;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 4; ++c)
      if (b[r * 4 + c] == b[(r + 1) * 4 + c]) return false;
  return true;
}

// n-tuple spec: num_feat tuples, each up to 6 cells; exponents are
// clipped at 13 for base-14 tuples (reference f_6, r_learning.py:58-69).
struct TupleSpec {
  int32_t num_feat;
  const int32_t* cells;    // (num_feat * 6) cell indices, -1 padded
  const int32_t* lens;     // (num_feat,)
  const int32_t* bases;    // (num_feat,) 16 or 14
  const int64_t* offsets;  // (num_feat,) flat-table offsets
};

float eval_board_impl(const int8_t* b, const float* w, const TupleSpec* ts) {
  float v = 0.0f;
  for (int f = 0; f < ts->num_feat; ++f) {
    const int32_t* cells = ts->cells + f * 6;
    int len = ts->lens[f];
    int base = ts->bases[f];
    int64_t idx = 0;
    for (int j = 0; j < len; ++j) {
      int x = b[cells[j]];
      if (base == 14 && x > 13) x = 13;
      idx = idx * base + x;
    }
    v += w[ts->offsets[f] + idx];
  }
  return v;
}

float expectimax_impl(const int8_t* b, const float* w, const TupleSpec* ts,
                      int depth, int width, int since_empty, uint32_t* rng) {
  int empty = count_empty_impl(b);
  if (depth == 0 || empty >= since_empty) return eval_board_impl(b, w, ts);

  // sample min(width, empty) distinct empty cells (partial Fisher-Yates)
  int cells[16];
  int n = 0;
  for (int i = 0; i < 16; ++i)
    if (!b[i]) cells[n++] = i;
  int take = std::min(width, n);
  float total = 0.0f;
  int counted = 0;
  for (int s = 0; s < take; ++s) {
    int r = s + int(xorshift32(rng) % uint32_t(n - s));
    std::swap(cells[s], cells[r]);
    int8_t child[16];
    std::memcpy(child, b, 16);
    child[cells[s]] = (uniform01(rng) < 0.9) ? 1 : 2;

    // ref game_logic.py:229-241: dead child scores -100, then every
    // child's contribution is clamped at 0 in the average — so a
    // dead child contributes exactly 0.
    float contrib = 0.0f;
    if (!game_over_impl(child)) {
      float best = -1e30f;
      for (int dir = 0; dir < 4; ++dir) {
        int8_t aft[16];
        std::memcpy(aft, child, 16);
        bool changed = false;
        apply_move_impl(aft, dir, &changed);
        if (!changed) continue;
        float v = expectimax_impl(aft, w, ts, depth - 1, width,
                                  since_empty, rng);
        if (v > best) best = v;
      }
      contrib = std::max(best, 0.0f);
    }
    total += contrib;
    ++counted;
  }
  return counted ? total / float(counted)
                 : eval_board_impl(b, w, ts);
}

}  // namespace

extern "C" {

void build_luts() { build_luts_impl(); }

// returns score delta; changed flag via out param
int32_t apply_move(int8_t* board, int32_t dir, uint8_t* changed) {
  bool ch = false;
  int32_t d = apply_move_impl(board, dir, &ch);
  if (changed) *changed = ch ? 1 : 0;
  return ch ? d : -1;
}

int32_t count_empty(const int8_t* board) { return count_empty_impl(board); }

uint8_t game_over(const int8_t* board) {
  return game_over_impl(board) ? 1 : 0;
}

// uniform spawn over empties: tile exp 1 w.p. 0.9 else 2.
// returns pos (0..15) or -1 if board full; value via out param.
int32_t spawn(int8_t* board, uint32_t* rng_state, int32_t* val_out) {
  int cells[16];
  int n = 0;
  for (int i = 0; i < 16; ++i)
    if (!board[i]) cells[n++] = i;
  if (!n) return -1;
  int pos = cells[xorshift32(rng_state) % uint32_t(n)];
  int val = (uniform01(rng_state) < 0.9) ? 1 : 2;
  board[pos] = int8_t(val);
  if (val_out) *val_out = val;
  return pos;
}

float eval_board(const int8_t* board, const float* weights,
                 int32_t num_feat, const int32_t* cells,
                 const int32_t* lens, const int32_t* bases,
                 const int64_t* offsets) {
  TupleSpec ts{num_feat, cells, lens, bases, offsets};
  return eval_board_impl(board, weights, &ts);
}

float expectimax(const int8_t* board, const float* weights,
                 int32_t num_feat, const int32_t* cells,
                 const int32_t* lens, const int32_t* bases,
                 const int64_t* offsets, int32_t depth, int32_t width,
                 int32_t since_empty, uint32_t* rng_state) {
  TupleSpec ts{num_feat, cells, lens, bases, offsets};
  return expectimax_impl(board, weights, &ts, depth, width, since_empty,
                         rng_state);
}

// greedy (or expectimax) action over the 4 afterstates; returns dir
// 0-3 or -1 if no legal move.  delta_out = score gained by the move;
// board is updated in place to the chosen afterstate (pre-spawn).
int32_t best_move(int8_t* board, const float* weights, int32_t num_feat,
                  const int32_t* cells, const int32_t* lens,
                  const int32_t* bases, const int64_t* offsets,
                  int32_t depth, int32_t width, int32_t since_empty,
                  uint32_t* rng_state, int32_t* delta_out) {
  TupleSpec ts{num_feat, cells, lens, bases, offsets};
  float best_v = -1e30f;
  int best_dir = -1;
  int32_t best_delta = 0;
  int8_t best_board[16];
  for (int dir = 0; dir < 4; ++dir) {
    int8_t aft[16];
    std::memcpy(aft, board, 16);
    bool changed = false;
    int32_t delta = apply_move_impl(aft, dir, &changed);
    if (!changed) continue;
    float v = (depth > 0)
                  ? expectimax_impl(aft, weights, &ts, depth, width,
                                    since_empty, rng_state)
                  : eval_board_impl(aft, weights, &ts);
    if (v > best_v) {
      best_v = v;
      best_dir = dir;
      best_delta = delta;
      std::memcpy(best_board, aft, 16);
    }
  }
  if (best_dir >= 0) {
    std::memcpy(board, best_board, 16);
    if (delta_out) *delta_out = best_delta;
  }
  return best_dir;
}

// full greedy game from the given start board; returns final score.
// Used for fast host-side statistics and as a perf probe.
int64_t play_game(int8_t* board, const float* weights, int32_t num_feat,
                  const int32_t* cells, const int32_t* lens,
                  const int32_t* bases, const int64_t* offsets,
                  int32_t depth, int32_t width, int32_t since_empty,
                  uint32_t* rng_state, int32_t* moves_out) {
  int64_t score = 0;
  int32_t moves = 0;
  for (;;) {
    int32_t delta = 0;
    int dir = best_move(board, weights, num_feat, cells, lens, bases,
                        offsets, depth, width, since_empty, rng_state,
                        &delta);
    if (dir < 0) break;
    score += delta;
    ++moves;
    int32_t val = 0;
    spawn(board, rng_state, &val);
  }
  if (moves_out) *moves_out = moves;
  return score;
}

}  // extern "C"

// Native search runtime: MAC cost model + evolutionary network_def operators.
//
// The evolutionary search's host-side hot path is rejection sampling:
// random/mutate/crossover proposals are re-drawn until their MAC estimate
// lands in [0.975*constraint, constraint] (reference
// search_utils/gen_utils.py:234-383 runs this in pure Python over nested
// lists; its driver notes the CPU-bound loop).  This module implements the
// cost model and the three operators over a flat integer encoding, exposed
// through a C ABI consumed via ctypes (vit_search_torch/native/__init__.py).
// A copy of the JAX package's vit_search_tpu/native/vitsearch_native.cpp:
// only the comments differ, so both packages draw the same candidates under
// one seed.
//
// network_def encoding: int64[n_blocks * 6], fields per block:
//   [type, f1, f2, f3, f4, f5]
//   type 0/4 (linear/conv embed): f1=embed
//   type 5   (flex conv embed):   f1=embed, f2=mid
//   type 1   (transformer):       f1=embed, f2=heads, f3=head_dim,
//                                 f4=ffn_hidden, f5=exists
//   type 2   (head):              f1=in, f2=classes
//   type 3   (spatial reduction): f1=in,  f2=out
//
// Search-space encoding: candidate widths flattened into `vals` with
// per-block offsets/lengths at slots [block*3 + j]:
//   j=0: embed/SR widths (or attention widths for transformers)
//   j=1: MLP hidden widths (transformers only)
//   j=2: layer-existence widths, 0 marks removable (empty if not removable)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>

namespace {

constexpr int kFields = 6;
constexpr int T_EMBED = 0, T_TRANS = 1, T_HEAD = 2, T_SR = 3, T_CONV = 4,
              T_FLEX = 5;
constexpr double kLowerBound = 0.975;  // resource band, gen_utils.py:53

struct Net {
  int64_t* d;
  int n;
  int64_t* blk(int i) { return d + i * kFields; }
  const int64_t* blk(int i) const { return d + i * kFields; }
  int type(int i) const { return static_cast<int>(blk(i)[0]); }
};

struct Space {
  const int64_t* vals;
  const int64_t* offs;  // n_blocks * 3
  const int64_t* lens;
  int n;
  const int64_t* list(int block, int j, int* len) const {
    *len = static_cast<int>(lens[block * 3 + j]);
    return vals + offs[block * 3 + j];
  }
  bool removable(int block) const {
    int len;
    const int64_t* l = list(block, 2, &len);
    for (int i = 0; i < len; ++i)
      if (l[i] == 0) return true;
    return false;
  }
};

// ---------------- cost model (parity with arch/cost.py) ----------------

struct Factors {
  int64_t mul, bias, misc;
  explicit Factors(bool mac) : mul(mac ? 1 : 2), bias(mac ? 0 : 1),
                               misc(mac ? 0 : 1) {}
};

constexpr int64_t kSoftmaxFlops = 5, kLnFlops = 5, kGeluFlops = 8;

int64_t attention_cost(int64_t e, int64_t h, int64_t d, int64_t n, Factors f) {
  int64_t w = h * d, c = 0;
  c += e * w * 3 * n * f.mul;
  c += w * 3 * n * f.bias;
  c += n * n * w * f.mul;
  c += n * h * n * kSoftmaxFlops * f.misc;
  c += n * n * h * f.misc;
  c += n * n * w * f.mul;
  c += n * w * e * f.mul;
  c += n * e * f.bias;
  c += n * e * f.misc;
  c += n * e * kLnFlops * f.misc;
  return c;
}

int64_t ffn_cost(int64_t e, int64_t hid, int64_t n, Factors f) {
  int64_t c = 0;
  c += n * e * hid * f.mul;
  c += n * hid * f.bias;
  c += n * hid * kGeluFlops * f.misc;
  c += n * e * hid * f.mul;
  c += n * e * f.bias;
  c += n * e * f.misc;
  c += n * e * kLnFlops * f.misc;
  return c;
}

int64_t patch_embed_cost(int64_t e, int64_t npatch, int64_t nch, int64_t p,
                         Factors f, int64_t mid, bool conv) {
  int64_t c = 0;
  if (conv) {
    const int64_t k = 3, mid_res = 112;
    int64_t pp = p / 2;
    c += (nch * mid * k * k) * mid_res * mid_res * f.mul;
    c += (mid * mid_res * mid_res) * f.bias;
    c += (mid * mid * k * k) * mid_res * mid_res * f.mul * 2;
    c += (mid * mid_res * mid_res) * f.bias * 2;
    c += (e * mid) * pp * pp * npatch * f.mul;
    c += e * npatch * f.bias;
  } else {
    c += (e * nch) * p * p * npatch * f.mul;
    c += e * npatch * f.bias;
  }
  return c;
}

int64_t head_cost(int64_t e, int64_t n, int64_t classes, Factors f) {
  return e * kLnFlops * f.misc + e * classes * f.mul + n * classes * f.bias;
}

int64_t sr_cost(int64_t img, int64_t p, int64_t cin, int64_t cout, bool distill,
                Factors f) {
  int64_t out = img / p, c = 0;
  c += (out * out * cout) * ((p + 1) * (p + 1) * cin) * f.mul;
  c += out * out * cout * f.bias;
  c += out * out * cout * kLnFlops * f.misc;
  c += out * out * cout * f.bias;
  int64_t tok = cin * kLnFlops * f.misc + cin * cout * f.mul + cout * f.bias +
                cin * f.misc;
  if (distill) tok *= 2;
  return c + tok;
}

int64_t estimate(const Net& net, bool distill, int64_t resolution,
                 int64_t patch, int64_t num_in_ch, bool mac) {
  Factors f(mac);
  int64_t img = resolution / patch;
  int64_t npatch = img * img;
  int64_t ntok = distill ? 2 : 1;
  int64_t nseq = npatch + ntok;

  const int64_t* stem = net.blk(0);
  int stem_type = static_cast<int>(stem[0]);
  int64_t embed = stem[1];
  bool conv = stem_type != T_EMBED;
  int64_t mid = stem_type == T_FLEX ? stem[2] : 24;

  int64_t c = patch_embed_cost(embed, npatch, num_in_ch, patch, f, mid, conv);
  c += embed * nseq * f.bias;  // position embedding

  for (int i = 0; i < net.n; ++i) {
    const int64_t* b = net.blk(i);
    if (b[0] == T_TRANS) {
      if (!b[5]) continue;
      c += attention_cost(b[1], b[2], b[3], nseq, f);
      c += ffn_cost(b[1], b[4], nseq, f);
    } else if (b[0] == T_SR) {
      c += sr_cost(img, 2, b[1], b[2], distill, f);
      img /= 2;
      npatch = img * img;
      nseq = npatch + ntok;
      embed = b[2];
    }
  }
  int64_t head = head_cost(embed, nseq, net.blk(net.n - 1)[2], f);
  if (distill) head *= 2;
  return c + head;
}

// ------------- IR invariants (parity with arch/network_def.py) -------------

void update_embed_size(Net& net) {
  int64_t embed = net.blk(0)[1];
  for (int i = 1; i < net.n; ++i) {
    int64_t* b = net.blk(i);
    switch (b[0]) {
      case T_TRANS: b[1] = embed; break;
      case T_HEAD: b[1] = embed; break;
      case T_SR: b[1] = embed; embed = b[2]; break;
      default: break;
    }
  }
}

void update_depth(Net& net, const Space& sp) {
  bool remove = false;
  for (int i = 0; i < net.n; ++i) {
    int64_t* b = net.blk(i);
    if (b[0] != T_TRANS) continue;
    if (!sp.removable(i)) {
      remove = false;
    } else if (remove) {
      b[5] = 0;
    } else if (!b[5]) {
      remove = true;
    }
  }
}

// -------------------- operators (parity with search/generators.py) ---------

using Rng = std::mt19937_64;

int64_t choice(const int64_t* vals, int len, Rng& rng) {
  return vals[std::uniform_int_distribution<int>(0, len - 1)(rng)];
}

double uniform(Rng& rng) {
  return std::uniform_real_distribution<double>(0.0, 1.0)(rng);
}

// next candidate strictly below current (lists sorted descending)
int64_t prune_next(const int64_t* vals, int len, int64_t current) {
  for (int i = 0; i < len; ++i)
    if (vals[i] < current) return vals[i];
  return current;
}

struct Estimator {
  bool distill;
  int64_t resolution, patch, num_in_ch;
  int64_t operator()(const Net& net) const {
    return estimate(net, distill, resolution, patch, num_in_ch, true);
  }
};

void prune_random_one(Net& net, const Space& sp, bool prune_embed,
                      bool prune_block, Rng& rng) {
  int num_blocks = net.n - 1;  // never the head
  int start = prune_embed ? 0 : 1;
  int idx = std::uniform_int_distribution<int>(start, num_blocks - 1)(rng);
  if (!prune_embed) {
    while (net.type(idx) != T_TRANS)
      idx = std::uniform_int_distribution<int>(start, num_blocks - 1)(rng);
  }
  int64_t* b = net.blk(idx);
  int len;
  switch (b[0]) {
    case T_EMBED: case T_CONV: case T_FLEX: {
      const int64_t* l = sp.list(idx, 0, &len);
      b[1] = prune_next(l, len, b[1]);
      update_embed_size(net);
      break;
    }
    case T_TRANS: {
      bool removable = sp.removable(idx) && prune_block;
      int options = removable ? 3 : 2;
      int pick = std::uniform_int_distribution<int>(0, options - 1)(rng);
      if (pick == 0) {
        const int64_t* l = sp.list(idx, 0, &len);
        // attention widths -> head counts at this block's head_dim
        int64_t heads = b[2];
        for (int i = 0; i < len; ++i) {
          int64_t h = l[i] / b[3];
          if (h < b[2]) { heads = h; break; }
        }
        b[2] = heads;
      } else if (pick == 1) {
        const int64_t* l = sp.list(idx, 1, &len);
        b[4] = prune_next(l, len, b[4]);
      } else {
        const int64_t* l = sp.list(idx, 2, &len);
        if (choice(l, len, rng) == 0) {
          b[5] = 0;
          update_depth(net, sp);
        }
      }
      break;
    }
    case T_SR: {
      const int64_t* l = sp.list(idx, 0, &len);
      int64_t next = prune_next(l, len, b[2]);
      if (next != b[2]) {
        b[2] = next;
        update_embed_size(net);
      }
      break;
    }
    default: break;
  }
}

void reduce_constraint(Net& net, const Space& sp, double constraint,
                       const Estimator& est, Rng& rng) {
  int tries = 0;
  while (static_cast<double>(est(net)) > constraint) {
    bool aggressive = tries >= 100;
    prune_random_one(net, sp, aggressive, aggressive, rng);
    ++tries;
  }
}

void random_sample_embed_depth(const Net& largest, Net& net, const Space& sp,
                               Rng& rng) {
  std::memcpy(net.d, largest.d, sizeof(int64_t) * net.n * kFields);
  int len;
  for (int i = 0; i < net.n; ++i) {
    int64_t* b = net.blk(i);
    switch (b[0]) {
      case T_EMBED: case T_CONV: case T_FLEX: {
        const int64_t* l = sp.list(i, 0, &len);
        b[1] = choice(l, len, rng);
        update_embed_size(net);
        break;
      }
      case T_TRANS: {
        if (sp.removable(i)) {
          const int64_t* l = sp.list(i, 2, &len);
          if (choice(l, len, rng) == 0) b[5] = 0;
        }
        break;
      }
      case T_SR: {
        const int64_t* l = sp.list(i, 0, &len);
        b[2] = choice(l, len, rng);
        update_embed_size(net);
        break;
      }
      default: break;
    }
  }
  update_depth(net, sp);
}

void mutate_once(const Net& parent, Net& net, const Space& sp, double m_prob,
                 Rng& rng) {
  std::memcpy(net.d, parent.d, sizeof(int64_t) * net.n * kFields);
  int len;
  for (int i = 0; i < net.n; ++i) {
    int64_t* b = net.blk(i);
    switch (b[0]) {
      case T_EMBED: case T_CONV: case T_FLEX:
        if (uniform(rng) <= m_prob) {
          const int64_t* l = sp.list(i, 0, &len);
          b[1] = choice(l, len, rng);
          update_embed_size(net);
        }
        break;
      case T_TRANS: {
        if (uniform(rng) <= m_prob) {
          const int64_t* l = sp.list(i, 0, &len);
          b[2] = choice(l, len, rng) / b[3];
        }
        if (uniform(rng) <= m_prob) {
          const int64_t* l = sp.list(i, 1, &len);
          b[4] = choice(l, len, rng);
        }
        if (sp.removable(i) && uniform(rng) <= m_prob) {
          b[5] = b[5] ? 0 : 1;  // flip existence
          update_depth(net, sp);
        }
        break;
      }
      case T_SR:
        if (uniform(rng) <= m_prob) {
          const int64_t* l = sp.list(i, 0, &len);
          b[2] = choice(l, len, rng);
          update_embed_size(net);
        }
        break;
      default: break;
    }
  }
}

void crossover_once(const Net& m, const Net& f, Net& net, const Space& sp,
                    Rng& rng) {
  std::memcpy(net.d, m.d, sizeof(int64_t) * net.n * kFields);
  for (int i = 0; i < net.n; ++i) {
    int64_t* b = net.blk(i);
    const int64_t* fb = f.blk(i);
    switch (b[0]) {
      case T_EMBED: case T_CONV: case T_FLEX:
        if (uniform(rng) <= 0.5) { b[1] = fb[1]; update_embed_size(net); }
        break;
      case T_TRANS:
        if (uniform(rng) <= 0.5) b[2] = fb[2];
        if (uniform(rng) <= 0.5) b[4] = fb[4];
        if (uniform(rng) <= 0.5) { b[5] = fb[5]; update_depth(net, sp); }
        break;
      case T_SR:
        if (uniform(rng) <= 0.5) { b[2] = fb[2]; update_embed_size(net); }
        break;
      default: break;
    }
  }
}

}  // namespace

extern "C" {

int64_t vs_estimate_mac(const int64_t* net_data, int n_blocks, int distill,
                          int resolution, int patch, int num_in_ch,
                          int return_mac) {
  Net net{const_cast<int64_t*>(net_data), n_blocks};
  return estimate(net, distill != 0, resolution, patch, num_in_ch,
                  return_mac != 0);
}

// Rejection-sample a random candidate into [0.975c, c].  Returns the number
// of proposals evaluated (for instrumentation), or -1 on failure.
int vs_gen_random(const int64_t* largest, int n_blocks,
                  const int64_t* vals, const int64_t* offs,
                  const int64_t* lens, double constraint, int distill,
                  int resolution, int patch, uint64_t seed,
                  int64_t* out, int max_tries) {
  Net largest_net{const_cast<int64_t*>(largest), n_blocks};
  Net net{out, n_blocks};
  Space sp{vals, offs, lens, n_blocks};
  Estimator est{distill != 0, resolution, patch, 3};
  Rng rng(seed);
  double lo = kLowerBound * constraint;
  for (int tries = 1; tries <= max_tries; ++tries) {
    random_sample_embed_depth(largest_net, net, sp, rng);
    int inner = 0;
    while (static_cast<double>(est(net)) < lo && inner++ < max_tries)
      random_sample_embed_depth(largest_net, net, sp, rng);
    reduce_constraint(net, sp, constraint, est, rng);
    double r = static_cast<double>(est(net));
    if (r >= lo && r <= constraint) return tries;
  }
  return -1;
}

int vs_mutate(const int64_t* parent, int n_blocks, const int64_t* vals,
              const int64_t* offs, const int64_t* lens, double m_prob,
              double constraint, int distill, int resolution, int patch,
              uint64_t seed, int64_t* out, int max_tries) {
  Net parent_net{const_cast<int64_t*>(parent), n_blocks};
  Net net{out, n_blocks};
  Space sp{vals, offs, lens, n_blocks};
  Estimator est{distill != 0, resolution, patch, 3};
  Rng rng(seed);
  double lo = kLowerBound * constraint;
  for (int tries = 1; tries <= max_tries; ++tries) {
    mutate_once(parent_net, net, sp, m_prob, rng);
    double r = static_cast<double>(est(net));
    if (r >= lo && r <= constraint) return tries;
  }
  return -1;
}

int vs_crossover(const int64_t* mother, const int64_t* father,
                 int n_blocks, const int64_t* vals, const int64_t* offs,
                 const int64_t* lens, double constraint, int distill,
                 int resolution, int patch, uint64_t seed,
                 int64_t* out, int max_tries) {
  Net m{const_cast<int64_t*>(mother), n_blocks};
  Net f{const_cast<int64_t*>(father), n_blocks};
  Net net{out, n_blocks};
  Space sp{vals, offs, lens, n_blocks};
  Estimator est{distill != 0, resolution, patch, 3};
  Rng rng(seed);
  double lo = kLowerBound * constraint;
  for (int tries = 1; tries <= max_tries; ++tries) {
    crossover_once(m, f, net, sp, rng);
    double r = static_cast<double>(est(net));
    if (r >= lo && r <= constraint) return tries;
  }
  return -1;
}

}  // extern "C"

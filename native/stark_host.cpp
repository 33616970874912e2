// Native host runtime for the STARK framework.
//
// The reference implements its entire host path in Rust; this library is the
// C++ equivalent of its host-side hot loops, exposed through a tiny C ABI
// consumed via ctypes (no pybind11 in this image):
//
//  * blake2s-256 (single + batched): the transcript / Merkle hash
//    (`/root/reference/packages/commitment/src/blake.rs:28-32`,
//    `utils.rs:5-10`).
//  * .r1cs / .wtns binary parsers (data loader): flat-array output
//    (`circom2bellman_core/src/reader.rs:4-89`, `r1cs-stark/src/reader.rs:7-42`).
//  * the arithmetization core (graph builder): S/P/K streams, flags,
//    copy-constraint permutation, public-first indices
//    (`r1cs-stark/src/run.rs:109-308,390-419`) with 4x64 Montgomery
//    multiplication for the running dot product.
//
// Build: g++ -O3 -march=native -shared -fPIC stark_host.cpp -o libstark_host.so

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// ---------------------------------------------------------------------------
// blake2s-256 (RFC 7693, unkeyed, 32-byte digest)
// ---------------------------------------------------------------------------

static const uint32_t B2S_IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

static const uint8_t B2S_SIGMA[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
};

static inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void b2s_compress(uint32_t h[8], const uint8_t block[64], uint64_t t,
                         bool last) {
  uint32_t m[16], v[16];
  for (int i = 0; i < 16; i++) {
    m[i] = (uint32_t)block[4 * i] | ((uint32_t)block[4 * i + 1] << 8) |
           ((uint32_t)block[4 * i + 2] << 16) |
           ((uint32_t)block[4 * i + 3] << 24);
  }
  for (int i = 0; i < 8; i++) v[i] = h[i];
  for (int i = 0; i < 8; i++) v[8 + i] = B2S_IV[i];
  v[12] ^= (uint32_t)t;
  v[13] ^= (uint32_t)(t >> 32);
  if (last) v[14] = ~v[14];

#define B2S_G(a, b, c, d, x, y)                                            \
  do {                                                                     \
    v[a] = v[a] + v[b] + (x);                                              \
    v[d] = rotr32(v[d] ^ v[a], 16);                                        \
    v[c] = v[c] + v[d];                                                    \
    v[b] = rotr32(v[b] ^ v[c], 12);                                        \
    v[a] = v[a] + v[b] + (y);                                              \
    v[d] = rotr32(v[d] ^ v[a], 8);                                         \
    v[c] = v[c] + v[d];                                                    \
    v[b] = rotr32(v[b] ^ v[c], 7);                                         \
  } while (0)

  for (int r = 0; r < 10; r++) {
    const uint8_t* s = B2S_SIGMA[r];
    B2S_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
    B2S_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
    B2S_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
    B2S_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
    B2S_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
    B2S_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
    B2S_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
    B2S_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
#undef B2S_G
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[8 + i];
}

void stark_blake2s(const uint8_t* msg, uint64_t len, uint8_t out[32]) {
  uint32_t h[8];
  for (int i = 0; i < 8; i++) h[i] = B2S_IV[i];
  h[0] ^= 0x01010020u;  // depth 1, fanout 1, digest 32, no key
  uint64_t t = 0;
  uint64_t remaining = len;
  const uint8_t* p = msg;
  // at least one block (empty message hashes one zero block)
  while (remaining > 64) {
    t += 64;
    b2s_compress(h, p, t, false);
    p += 64;
    remaining -= 64;
  }
  uint8_t block[64];
  memset(block, 0, 64);
  memcpy(block, p, (size_t)remaining);
  t += remaining;
  b2s_compress(h, block, t, true);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (uint8_t)h[i];
    out[4 * i + 1] = (uint8_t)(h[i] >> 8);
    out[4 * i + 2] = (uint8_t)(h[i] >> 16);
    out[4 * i + 3] = (uint8_t)(h[i] >> 24);
  }
}

// n messages of msg_len bytes each, contiguous; out: n*32 bytes
void stark_blake2s_batch(const uint8_t* msgs, uint64_t n, uint64_t msg_len,
                         uint8_t* out) {
  for (uint64_t i = 0; i < n; i++) {
    stark_blake2s(msgs + i * msg_len, msg_len, out + i * 32);
  }
}

// Merkle fold: n digests (n*32 bytes) -> n/2 digests (hash of concatenated
// pairs), n even.
void stark_merkle_fold(const uint8_t* layer, uint64_t n, uint8_t* out) {
  for (uint64_t i = 0; i < n / 2; i++) {
    stark_blake2s(layer + i * 64, 64, out + i * 32);
  }
}

// ---------------------------------------------------------------------------
// 4x64 field arithmetic (generic modulus < 2^256, Montgomery R = 2^256)
// ---------------------------------------------------------------------------

typedef unsigned __int128 u128;

struct Fp4 {
  uint64_t v[4];
};

static inline bool fp_gte(const Fp4& a, const Fp4& b) {
  for (int i = 3; i >= 0; i--) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return true;
}

static inline void fp_sub_inplace(Fp4& a, const Fp4& b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    a.v[i] = (uint64_t)d;
    borrow = (d >> 64) & 1;  // borrow if wrapped
  }
}

static inline void fp_add_mod(Fp4& a, const Fp4& b, const Fp4& p) {
  u128 carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    a.v[i] = (uint64_t)s;
    carry = s >> 64;
  }
  if (carry || fp_gte(a, p)) fp_sub_inplace(a, p);
}

// Montgomery context
struct MontCtx {
  Fp4 p;
  uint64_t n0;  // -p^{-1} mod 2^64
  Fp4 r2;       // R^2 mod p
};

static uint64_t inv64(uint64_t a) {  // a odd: a^{-1} mod 2^64 (Newton)
  uint64_t x = a;  // correct to 3 bits
  for (int i = 0; i < 5; i++) x *= 2 - a * x;
  return x;
}

static void mont_init(MontCtx& ctx, const uint8_t p_le[32]) {
  for (int i = 0; i < 4; i++) {
    uint64_t w = 0;
    for (int j = 0; j < 8; j++) w |= (uint64_t)p_le[8 * i + j] << (8 * j);
    ctx.p.v[i] = w;
  }
  ctx.n0 = (uint64_t)(0 - inv64(ctx.p.v[0]));
  // R^2 mod p by 512 doublings of 1
  Fp4 r = {{1, 0, 0, 0}};
  if (fp_gte(r, ctx.p)) fp_sub_inplace(r, ctx.p);
  for (int i = 0; i < 512; i++) {
    Fp4 t = r;
    fp_add_mod(r, t, ctx.p);
  }
  ctx.r2 = r;
}

// CIOS Montgomery multiplication: returns a*b*R^{-1} mod p
static void mont_mul(const MontCtx& c, const Fp4& a, const Fp4& b, Fp4& out) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 s = (u128)t[j] + (u128)a.v[j] * b.v[i] + carry;
      t[j] = (uint64_t)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (uint64_t)s;
    t[5] = (uint64_t)(s >> 64);
    uint64_t m = t[0] * c.n0;
    carry = 0;
    {
      u128 s0 = (u128)t[0] + (u128)m * c.p.v[0];
      carry = s0 >> 64;
    }
    for (int j = 1; j < 4; j++) {
      u128 s1 = (u128)t[j] + (u128)m * c.p.v[j] + carry;
      t[j - 1] = (uint64_t)s1;
      carry = s1 >> 64;
    }
    u128 s2 = (u128)t[4] + carry;
    t[3] = (uint64_t)s2;
    t[4] = t[5] + (uint64_t)(s2 >> 64);
    t[5] = 0;
  }
  Fp4 r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || fp_gte(r, c.p)) fp_sub_inplace(r, c.p);
  out = r;
}

// reduce an arbitrary 32-byte LE value mod p (value < 2^256 <= 16p)
static void fp_from_le(const MontCtx& c, const uint8_t le[32], Fp4& out) {
  for (int i = 0; i < 4; i++) {
    uint64_t w = 0;
    for (int j = 0; j < 8; j++) w |= (uint64_t)le[8 * i + j] << (8 * j);
    out.v[i] = w;
  }
  // value < 2^256; subtract p until canonical (<= ~9 iterations for BN254)
  while (fp_gte(out, c.p)) fp_sub_inplace(out, c.p);
}

static void fp_to_le(const Fp4& a, uint8_t le[32]) {
  for (int i = 0; i < 4; i++) {
    for (int j = 0; j < 8; j++) le[8 * i + j] = (uint8_t)(a.v[i] >> (8 * j));
  }
}

// ---------------------------------------------------------------------------
// .r1cs parser (iden3 binary; reader.rs:4-89 semantics)
// ---------------------------------------------------------------------------

struct Rdr {
  const uint8_t* p;
  uint64_t len;
  uint64_t pos;
  bool ok;
};

static inline uint32_t rd_u32(Rdr& r) {
  if (r.pos + 4 > r.len) { r.ok = false; return 0; }
  uint32_t v;
  memcpy(&v, r.p + r.pos, 4);
  r.pos += 4;
  return v;
}

static inline uint64_t rd_u64(Rdr& r) {
  if (r.pos + 8 > r.len) { r.ok = false; return 0; }
  uint64_t v;
  memcpy(&v, r.p + r.pos, 8);
  r.pos += 8;
  return v;
}

// Scan pass: header fields + total coefficient count.
// header_out (9 x u64): [version, field_size, n_wires, n_pub_out, n_pub_in,
//                        n_priv_in, n_labels, n_constraints, total_coeffs]
// prime_out: 32 bytes. Returns 0 on success.
int stark_r1cs_scan(const uint8_t* buf, uint64_t len, uint64_t header_out[9],
                    uint8_t prime_out[32]) {
  Rdr r = {buf, len, 0, true};
  if (rd_u32(r) != 0x73633172u) return 1;  // "r1cs"
  uint32_t version = rd_u32(r);
  if (version != 1) return 2;
  if (rd_u32(r) != 3) return 3;  // exactly 3 sections (reader.rs:14)
  if (rd_u32(r) != 1) return 4;  // header section
  rd_u64(r);                     // section size
  uint32_t field_size = rd_u32(r);
  if (field_size != 32 || r.pos + 32 > len) return 5;
  memcpy(prime_out, buf + r.pos, 32);
  r.pos += 32;
  uint32_t n_wires = rd_u32(r);
  uint32_t n_pub_out = rd_u32(r);
  uint32_t n_pub_in = rd_u32(r);
  uint32_t n_priv_in = rd_u32(r);
  uint64_t n_labels = rd_u64(r);
  uint32_t n_constraints = rd_u32(r);
  if (rd_u32(r) != 2) return 6;  // constraint section
  rd_u64(r);
  uint64_t total = 0;
  for (uint64_t ci = 0; ci < n_constraints && r.ok; ci++) {
    for (int f = 0; f < 3; f++) {
      uint32_t nc = rd_u32(r);
      total += nc;
      r.pos += (uint64_t)nc * (4 + 32);
      if (r.pos > len) { r.ok = false; }
    }
  }
  if (!r.ok) return 7;
  header_out[0] = version;
  header_out[1] = field_size;
  header_out[2] = n_wires;
  header_out[3] = n_pub_out;
  header_out[4] = n_pub_in;
  header_out[5] = n_priv_in;
  header_out[6] = n_labels;
  header_out[7] = n_constraints;
  header_out[8] = total;
  return 0;
}

// Fill pass: ncoeffs (3*n_constraints u32, A,B,C per constraint),
// wire_ids (total u32), values (total*32 u8). Returns 0 on success.
int stark_r1cs_fill(const uint8_t* buf, uint64_t len, uint64_t n_constraints,
                    uint32_t* ncoeffs, uint32_t* wire_ids, uint8_t* values) {
  Rdr r = {buf, len, 0, true};
  r.pos = 4 + 4 + 4;           // magic, version, n_sections
  r.pos += 4 + 8;              // header section type + size
  r.pos += 4 + 32 + 4 * 4 + 8 + 4;  // header body
  r.pos += 4 + 8;              // constraint section type + size
  uint64_t k = 0;
  for (uint64_t ci = 0; ci < n_constraints && r.ok; ci++) {
    for (int f = 0; f < 3; f++) {
      uint32_t nc = rd_u32(r);
      ncoeffs[3 * ci + f] = nc;
      for (uint32_t i = 0; i < nc && r.ok; i++) {
        wire_ids[k] = rd_u32(r);
        if (r.pos + 32 > len) { r.ok = false; break; }
        memcpy(values + k * 32, buf + r.pos, 32);
        r.pos += 32;
        k++;
      }
    }
  }
  return r.ok ? 0 : 1;
}

// ---------------------------------------------------------------------------
// .wtns parser (r1cs-stark/src/reader.rs:7-42 semantics)
// ---------------------------------------------------------------------------

// out_meta (2 x u64): [n_wires, field_size]
int stark_wtns_scan(const uint8_t* buf, uint64_t len, uint64_t out_meta[2]) {
  Rdr r = {buf, len, 0, true};
  if (rd_u32(r) != 1936618615u) return 1;  // "wtns"
  for (int i = 0; i < 5; i++) rd_u32(r);
  uint32_t field_size = rd_u32(r);
  r.pos += field_size;  // field order
  uint32_t n_wires = rd_u32(r);
  rd_u32(r); rd_u32(r); rd_u32(r);
  if (!r.ok) return 2;
  if (r.pos + (uint64_t)n_wires * field_size > len) return 3;
  out_meta[0] = n_wires;
  out_meta[1] = field_size;
  return 0;
}

// out: n_wires * field_size bytes (raw LE limbs per wire)
int stark_wtns_fill(const uint8_t* buf, uint64_t len, uint8_t* out) {
  uint64_t meta[2];
  int rc = stark_wtns_scan(buf, len, meta);
  if (rc) return rc;
  uint64_t n_wires = meta[0], field_size = meta[1];
  uint64_t pos = 4 + 5 * 4 + 4 + field_size + 4 + 3 * 4;
  memcpy(out, buf + pos, n_wires * field_size);
  return 0;
}

// ---------------------------------------------------------------------------
// arithmetization core (run.rs:109-308, 390-419)
// ---------------------------------------------------------------------------

// Inputs:
//   n_constraints, ncoeffs (3n u32), wire_ids (total u32),
//   values (total*32 u8 LE), witness (n_wires*32 u8 LE canonical, or NULL),
//   n_wires, n_public_wires, p_le (32 u8).
// Outputs (caller-allocated; trace_len = 3 * sum(max ncoeff per constraint)):
//   s_out, p_out, k_out: trace_len*32 u8 LE canonical (s/p only if witness)
//   f1_out, f2_out: trace_len u8
//   perm_out: trace_len u64 (copy-constraint permutation)
//   last_out: n_constraints u64
//   pub_first_out: 2*n_public_wires u64 as (wire, index) pairs;
//     n_pub_found_out: number of pairs written.
// Returns 0 on success.
int stark_arithmetize(uint64_t n_constraints, const uint32_t* ncoeffs,
                      const uint32_t* wire_ids, const uint8_t* values,
                      const uint8_t* witness, uint64_t n_wires,
                      uint64_t n_public_wires, const uint8_t p_le[32],
                      uint8_t* s_out, uint8_t* p_out, uint8_t* k_out,
                      uint8_t* f1_out, uint8_t* f2_out, uint64_t* perm_out,
                      uint64_t* last_out, uint64_t* pub_first_out,
                      uint64_t* n_pub_found_out) {
  // The .r1cs file is untrusted input: every wire_id indexes prev_use /
  // wit_mont / wit_le below, so an out-of-range id would be an OOB
  // read/write. Validate up front and fail loudly (the Python wrapper
  // turns nonzero codes into ValueError). The reference panics on the
  // same input (run.rs:159 indexes witness[wire_id]).
  if (n_wires == 0) return 10;
  {
    uint64_t total = 0;
    for (uint64_t i = 0; i < 3 * n_constraints; i++) total += ncoeffs[i];
    for (uint64_t i = 0; i < total; i++) {
      if (wire_ids[i] >= n_wires) return 11;
    }
  }

  MontCtx ctx;
  mont_init(ctx, p_le);

  // a_len = sum of per-constraint max ncoeff
  uint64_t a_len = 0;
  for (uint64_t ci = 0; ci < n_constraints; ci++) {
    uint32_t m = ncoeffs[3 * ci];
    if (ncoeffs[3 * ci + 1] > m) m = ncoeffs[3 * ci + 1];
    if (ncoeffs[3 * ci + 2] > m) m = ncoeffs[3 * ci + 2];
    a_len += m;
  }
  uint64_t trace_len = 3 * a_len;

  // witness in Montgomery form + canonical bytes (computed once per wire)
  Fp4* wit_mont = nullptr;
  uint8_t* wit_le = nullptr;
  if (witness) {
    wit_mont = new Fp4[n_wires];
    wit_le = new uint8_t[n_wires * 32];
    for (uint64_t w = 0; w < n_wires; w++) {
      Fp4 t;
      fp_from_le(ctx, witness + 32 * w, t);
      fp_to_le(t, wit_le + 32 * w);
      mont_mul(ctx, t, ctx.r2, wit_mont[w]);
    }
  }

  // per-wire last-use linked list for the permutation: for each slot we
  // need the previous slot using the same wire, cyclically. Two passes:
  // forward pass records prev-use; then each wire's first slot points to
  // its last slot (run.rs:390-401).
  int64_t* prev_use = new int64_t[n_wires];
  int64_t* first_use = new int64_t[n_wires];
  for (uint64_t w = 0; w < n_wires; w++) prev_use[w] = first_use[w] = -1;

  const uint64_t pad_wire = n_wires - 1;
  uint64_t src = 0;      // index into wire_ids/values
  uint64_t base_a = 0;   // slot offset within a region
  Fp4 zero = {{0, 0, 0, 0}};
  uint8_t zero_le[32];
  fp_to_le(zero, zero_le);

  // f1 defaults to 1, f2 to 0
  memset(f1_out, 1, trace_len);
  memset(f2_out, 0, trace_len);

  for (uint64_t ci = 0; ci < n_constraints; ci++) {
    uint32_t nc[3] = {ncoeffs[3 * ci], ncoeffs[3 * ci + 1], ncoeffs[3 * ci + 2]};
    uint32_t m = nc[0];
    if (nc[1] > m) m = nc[1];
    if (nc[2] > m) m = nc[2];
    uint64_t csrc = src;
    for (int region = 0; region < 3; region++) {
      Fp4 t = zero;
      for (uint32_t i = 0; i < m; i++) {
        uint64_t wire;
        Fp4 c;
        bool real = i < nc[region];
        if (real) {
          wire = wire_ids[csrc];
          fp_from_le(ctx, values + csrc * 32, c);
          csrc++;
        } else {
          wire = pad_wire;
          c = zero;
        }
        uint64_t slot = base_a + i;                  // within-region slot
        uint64_t gidx = (uint64_t)region * a_len + slot;  // global index
        // permutation bookkeeping
        if (prev_use[wire] >= 0) {
          perm_out[gidx] = (uint64_t)prev_use[wire];
        } else {
          first_use[wire] = (int64_t)gidx;
          perm_out[gidx] = (uint64_t)gidx;  // fixed up after the loop
        }
        prev_use[wire] = (int64_t)gidx;
        // K
        fp_to_le(c, k_out + gidx * 32);
        if (witness) {
          if (real) {
            // c standard x (w*R) with REDC = c*w exactly
            Fp4 cw;
            mont_mul(ctx, c, wit_mont[wire], cw);
            fp_add_mod(t, cw, ctx.p);
          }
          memcpy(s_out + gidx * 32, wit_le + wire * 32, 32);
          fp_to_le(t, p_out + gidx * 32);
        }
      }
    }
    src = csrc;
    base_a += m;
    uint64_t last = base_a - 1;
    last_out[ci] = last;
    // flags (run.rs:283-308): F1 = 0 at (last+1) mod a_len in all regions,
    // F2 = 1 at the A-region last slot
    uint64_t k1 = (last + 1) % a_len;
    f1_out[k1] = 0;
    f1_out[k1 + a_len] = 0;
    f1_out[k1 + 2 * a_len] = 0;
    f2_out[last] = 1;
  }

  // close permutation cycles: first use points to last use
  for (uint64_t w = 0; w < n_wires; w++) {
    if (first_use[w] >= 0) {
      perm_out[first_use[w]] = (uint64_t)prev_use[w];
    }
  }

  // public first indices (run.rs:411-419)
  uint64_t np = 0;
  for (uint64_t w = 0; w < n_public_wires && w < n_wires; w++) {
    if (first_use[w] >= 0) {
      pub_first_out[2 * np] = w;
      pub_first_out[2 * np + 1] = (uint64_t)first_use[w];
      np++;
    }
  }
  *n_pub_found_out = np;

  delete[] prev_use;
  delete[] first_use;
  delete[] wit_mont;
  delete[] wit_le;
  return 0;
}

// trace length helper (so python can allocate outputs)
uint64_t stark_trace_len(uint64_t n_constraints, const uint32_t* ncoeffs) {
  uint64_t a_len = 0;
  for (uint64_t ci = 0; ci < n_constraints; ci++) {
    uint32_t m = ncoeffs[3 * ci];
    if (ncoeffs[3 * ci + 1] > m) m = ncoeffs[3 * ci + 1];
    if (ncoeffs[3 * ci + 2] > m) m = ncoeffs[3 * ci + 2];
    a_len += m;
  }
  return 3 * a_len;
}

}  // extern "C"

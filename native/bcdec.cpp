// Native BC block decoders (BC4 / BC7 / BC6H) — the fast loader path.
//
// The reference leans on libktx (C/C++) for its texture pipeline
// (extern/ktx, src/wgpu.zig:130-194); tpurast's equivalent splits the
// container handling (Python, tpurast/assets/ktx2.py) from the hot
// block-decode loops, which live here. Semantics are identical to the
// numpy reference implementation in tpurast/assets/bcdec.py and
// bc6h.py — tests assert bit-equality between the two.
//
// Built on demand by tpurast/assets/native.py:
//   g++ -O3 -shared -fPIC -o libbcdec.so bcdec.cpp
// BC7 partition/anchor tables are injected at runtime via bc7_init()
// (they are derived empirically on the Python side; no duplication).

#include <cstdint>
#include <cstring>

namespace {

int8_t g_partitions2[64][16];
int8_t g_partitions3[64][16];
int8_t g_anchor2[64];
int8_t g_anchor3_second[64];
int8_t g_anchor3_third[64];

struct BitReader {
    const uint8_t* data;
    int pos = 0;
    explicit BitReader(const uint8_t* d) : data(d) {}
    uint64_t get(int n) {
        uint64_t v = 0;
        for (int i = 0; i < n; ++i, ++pos) {
            v |= uint64_t((data[pos >> 3] >> (pos & 7)) & 1) << i;
        }
        return v;
    }
    uint64_t get_reversed(int n) {  // MSB-first run (BC6H modes 0x0B/0x0F)
        uint64_t v = 0;
        for (int i = n - 1; i >= 0; --i, ++pos) {
            v |= uint64_t((data[pos >> 3] >> (pos & 7)) & 1) << i;
        }
        return v;
    }
};

const int kWeights2[4] = {0, 21, 43, 64};
const int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

inline int interp(int a, int b, int w) { return (a * (64 - w) + b * w + 32) >> 6; }

inline int expand_to_8(int v, int bits) {
    if (bits >= 8) return v;
    v <<= (8 - bits);
    return v | (v >> bits);
}

// ---------------------------------------------------------------- BC7 ----

struct Bc7Mode {
    int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 6, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 2, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 4, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 2, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 4, 0, 2, 0},
};

void decode_bc7_block(const uint8_t* block, uint8_t* out /*16*4*/) {
    int mode = -1;
    for (int m = 0; m < 8; ++m) {
        if (block[0] & (1 << m)) { mode = m; break; }
    }
    if (mode < 0) {  // reserved: transparent black per Khronos DFS
        std::memset(out, 0, 64);
        return;
    }
    const Bc7Mode& s = kBc7Modes[mode];
    BitReader br(block);
    br.get(mode + 1);
    int partition = int(br.get(s.pb));
    int rotation = int(br.get(s.rb));
    int index_sel = int(br.get(s.isb));

    int n_ep = 2 * s.ns;
    int eps[6][4] = {};
    for (int c = 0; c < 3; ++c)
        for (int e = 0; e < n_ep; ++e) eps[e][c] = int(br.get(s.cb));
    if (s.ab)
        for (int e = 0; e < n_ep; ++e) eps[e][3] = int(br.get(s.ab));

    int cbits = s.cb, abits = s.ab;
    if (s.epb) {
        int p[6];
        for (int e = 0; e < n_ep; ++e) p[e] = int(br.get(1));
        for (int e = 0; e < n_ep; ++e) {
            for (int c = 0; c < 3; ++c) eps[e][c] = (eps[e][c] << 1) | p[e];
            if (s.ab) eps[e][3] = (eps[e][3] << 1) | p[e];
        }
        cbits += 1;
        if (s.ab) abits += 1;
    } else if (s.spb) {
        int p[2];
        for (int ss = 0; ss < s.ns; ++ss) p[ss] = int(br.get(1));
        for (int e = 0; e < n_ep; ++e)
            for (int c = 0; c < 3; ++c) eps[e][c] = (eps[e][c] << 1) | p[e / 2];
        cbits += 1;
    }
    int eps8[6][4];
    for (int e = 0; e < n_ep; ++e) {
        for (int c = 0; c < 3; ++c) eps8[e][c] = expand_to_8(eps[e][c], cbits);
        eps8[e][3] = s.ab ? expand_to_8(eps[e][3], abits) : 255;
    }

    auto subset_of = [&](int i) -> int {
        if (s.ns == 1) return 0;
        if (s.ns == 2) return g_partitions2[partition][i];
        return g_partitions3[partition][i];
    };
    auto is_anchor = [&](int i) -> bool {
        if (i == 0) return true;
        if (s.ns == 2) return g_anchor2[partition] == i;
        if (s.ns == 3)
            return g_anchor3_second[partition] == i || g_anchor3_third[partition] == i;
        return false;
    };

    int idx1[16], idx2[16];
    for (int i = 0; i < 16; ++i) idx1[i] = int(br.get(s.ib - (is_anchor(i) ? 1 : 0)));
    if (s.ib2)
        for (int i = 0; i < 16; ++i) idx2[i] = int(br.get(s.ib2 - (i == 0 ? 1 : 0)));

    const int* w1 = s.ib == 2 ? kWeights2 : (s.ib == 3 ? kWeights3 : kWeights4);
    const int* w2 = s.ib2 == 2 ? kWeights2 : kWeights3;

    for (int i = 0; i < 16; ++i) {
        int sub = subset_of(i);
        const int* e0 = eps8[sub * 2];
        const int* e1 = eps8[sub * 2 + 1];
        int px[4];
        if (!s.ib2) {
            int w = w1[idx1[i]];
            for (int c = 0; c < 4; ++c) px[c] = interp(e0[c], e1[c], w);
        } else {
            int cw = w1[idx1[i]], aw = w2[idx2[i]];
            if (index_sel) { cw = w2[idx2[i]]; aw = w1[idx1[i]]; }
            for (int c = 0; c < 3; ++c) px[c] = interp(e0[c], e1[c], cw);
            px[3] = interp(e0[3], e1[3], aw);
        }
        if (rotation) {
            int ch = rotation - 1;  // 1->R, 2->G, 3->B swapped with A
            int t = px[ch]; px[ch] = px[3]; px[3] = t;
        }
        for (int c = 0; c < 4; ++c) out[i * 4 + c] = uint8_t(px[c]);
    }
}

// ---------------------------------------------------------------- BC4 ----

void decode_bc4_block(const uint8_t* block, uint8_t* out /*16*/) {
    int r0 = block[0], r1 = block[1];
    int pal[8];
    pal[0] = r0; pal[1] = r1;
    if (r0 > r1) {
        for (int k = 1; k <= 6; ++k) pal[k + 1] = ((7 - k) * r0 + k * r1) / 7;
    } else {
        for (int k = 1; k <= 4; ++k) pal[k + 1] = ((5 - k) * r0 + k * r1) / 5;
        pal[6] = 0; pal[7] = 255;
    }
    uint64_t bits = 0;
    for (int i = 0; i < 6; ++i) bits |= uint64_t(block[2 + i]) << (8 * i);
    for (int i = 0; i < 16; ++i) out[i] = uint8_t(pal[(bits >> (3 * i)) & 7]);
}

// --------------------------------------------------------------- BC6H ----

// Field ids for the declarative layout tables.
enum Field { RW, GW, BW, RX, GX, BX, RY, GY, BY, RZ, GZ, BZ, D, END };
struct Op { uint8_t field; int8_t hi, lo; };  // hi<lo => reversed run

#define OP(f, h, l) {f, h, l}
#define B(f, b) {f, b, b}

struct Bc6Mode { int epb; int dr, dg, db; bool two; const Op* ops; };

const Op kM00[] = {B(GY,4),B(BY,4),B(BZ,4),OP(RW,9,0),OP(GW,9,0),OP(BW,9,0),OP(RX,4,0),B(GZ,4),OP(GY,3,0),OP(GX,4,0),B(BZ,0),OP(GZ,3,0),OP(BX,4,0),B(BZ,1),OP(BY,3,0),OP(RY,4,0),B(BZ,2),OP(RZ,4,0),B(BZ,3),OP(D,4,0),{END,0,0}};
const Op kM01[] = {B(GY,5),B(GZ,4),B(GZ,5),OP(RW,6,0),B(BZ,0),B(BZ,1),B(BY,4),OP(GW,6,0),B(BY,5),B(BZ,2),B(GY,4),OP(BW,6,0),B(BZ,3),B(BZ,5),B(BZ,4),OP(RX,5,0),OP(GY,3,0),OP(GX,5,0),OP(GZ,3,0),OP(BX,5,0),OP(BY,3,0),OP(RY,5,0),OP(RZ,5,0),OP(D,4,0),{END,0,0}};
const Op kM02[] = {OP(RW,9,0),OP(GW,9,0),OP(BW,9,0),OP(RX,4,0),B(RW,10),OP(GY,3,0),OP(GX,3,0),B(GW,10),B(BZ,0),OP(GZ,3,0),OP(BX,3,0),B(BW,10),B(BZ,1),OP(BY,3,0),OP(RY,4,0),B(BZ,2),OP(RZ,4,0),B(BZ,3),OP(D,4,0),{END,0,0}};
const Op kM06[] = {OP(RW,9,0),OP(GW,9,0),OP(BW,9,0),OP(RX,3,0),B(RW,10),B(GZ,4),OP(GY,3,0),OP(GX,4,0),B(GW,10),OP(GZ,3,0),OP(BX,3,0),B(BW,10),B(BZ,1),OP(BY,3,0),OP(RY,3,0),B(BZ,0),B(BZ,2),OP(RZ,3,0),B(GY,4),B(BZ,3),OP(D,4,0),{END,0,0}};
const Op kM0A[] = {OP(RW,9,0),OP(GW,9,0),OP(BW,9,0),OP(RX,3,0),B(RW,10),B(BY,4),OP(GY,3,0),OP(GX,3,0),B(GW,10),B(BZ,0),OP(GZ,3,0),OP(BX,4,0),B(BW,10),OP(BY,3,0),OP(RY,3,0),B(BZ,1),B(BZ,2),OP(RZ,3,0),B(BZ,4),B(BZ,3),OP(D,4,0),{END,0,0}};
const Op kM0E[] = {OP(RW,8,0),B(BY,4),OP(GW,8,0),B(GY,4),OP(BW,8,0),B(BZ,4),OP(RX,4,0),B(GZ,4),OP(GY,3,0),OP(GX,4,0),B(BZ,0),OP(GZ,3,0),OP(BX,4,0),B(BZ,1),OP(BY,3,0),OP(RY,4,0),B(BZ,2),OP(RZ,4,0),B(BZ,3),OP(D,4,0),{END,0,0}};
const Op kM12[] = {OP(RW,7,0),B(GZ,4),B(BY,4),OP(GW,7,0),B(BZ,2),B(GY,4),OP(BW,7,0),B(BZ,3),B(BZ,4),OP(RX,5,0),OP(GY,3,0),OP(GX,4,0),B(BZ,0),OP(GZ,3,0),OP(BX,4,0),B(BZ,1),OP(BY,3,0),OP(RY,5,0),OP(RZ,5,0),OP(D,4,0),{END,0,0}};
const Op kM16[] = {OP(RW,7,0),B(BZ,0),B(BY,4),OP(GW,7,0),B(GY,5),B(GY,4),OP(BW,7,0),B(GZ,5),B(BZ,4),OP(RX,4,0),B(GZ,4),OP(GY,3,0),OP(GX,5,0),OP(GZ,3,0),OP(BX,4,0),B(BZ,1),OP(BY,3,0),OP(RY,4,0),B(BZ,2),OP(RZ,4,0),B(BZ,3),OP(D,4,0),{END,0,0}};
const Op kM1A[] = {OP(RW,7,0),B(BZ,1),B(BY,4),OP(GW,7,0),B(BY,5),B(GY,4),OP(BW,7,0),B(BZ,5),B(BZ,4),OP(RX,4,0),B(GZ,4),OP(GY,3,0),OP(GX,4,0),B(BZ,0),OP(GZ,3,0),OP(BX,5,0),OP(BY,3,0),OP(RY,4,0),B(BZ,2),OP(RZ,4,0),B(BZ,3),OP(D,4,0),{END,0,0}};
const Op kM1E[] = {OP(RW,5,0),B(GZ,4),B(BZ,0),B(BZ,1),B(BY,4),OP(GW,5,0),B(GY,5),B(BY,5),B(BZ,2),B(GY,4),OP(BW,5,0),B(GZ,5),B(BZ,3),B(BZ,5),B(BZ,4),OP(RX,5,0),OP(GY,3,0),OP(GX,5,0),OP(GZ,3,0),OP(BX,5,0),OP(BY,3,0),OP(RY,5,0),OP(RZ,5,0),OP(D,4,0),{END,0,0}};
const Op kM03[] = {OP(RW,9,0),OP(GW,9,0),OP(BW,9,0),OP(RX,9,0),OP(GX,9,0),OP(BX,9,0),{END,0,0}};
const Op kM07[] = {OP(RW,9,0),OP(GW,9,0),OP(BW,9,0),OP(RX,8,0),B(RW,10),OP(GX,8,0),B(GW,10),OP(BX,8,0),B(BW,10),{END,0,0}};
const Op kM0B[] = {OP(RW,9,0),OP(GW,9,0),OP(BW,9,0),OP(RX,7,0),OP(RW,10,11),OP(GX,7,0),OP(GW,10,11),OP(BX,7,0),OP(BW,10,11),{END,0,0}};
const Op kM0F[] = {OP(RW,9,0),OP(GW,9,0),OP(BW,9,0),OP(RX,3,0),OP(RW,10,15),OP(GX,3,0),OP(GW,10,15),OP(BX,3,0),OP(BW,10,15),{END,0,0}};

bool bc6_mode_of(int code, Bc6Mode* out) {
    switch (code) {
        case 0x00: *out = {10, 5, 5, 5, true, kM00}; return true;
        case 0x01: *out = {7, 6, 6, 6, true, kM01}; return true;
        case 0x02: *out = {11, 5, 4, 4, true, kM02}; return true;
        case 0x06: *out = {11, 4, 5, 4, true, kM06}; return true;
        case 0x0A: *out = {11, 4, 4, 5, true, kM0A}; return true;
        case 0x0E: *out = {9, 5, 5, 5, true, kM0E}; return true;
        case 0x12: *out = {8, 6, 5, 5, true, kM12}; return true;
        case 0x16: *out = {8, 5, 6, 5, true, kM16}; return true;
        case 0x1A: *out = {8, 5, 5, 6, true, kM1A}; return true;
        case 0x1E: *out = {6, 0, 0, 0, true, kM1E}; return true;
        case 0x03: *out = {10, 0, 0, 0, false, kM03}; return true;
        case 0x07: *out = {11, 9, 9, 9, false, kM07}; return true;
        case 0x0B: *out = {12, 8, 8, 8, false, kM0B}; return true;
        case 0x0F: *out = {16, 4, 4, 4, false, kM0F}; return true;
        default: return false;
    }
}

inline int64_t sign_extend(int64_t v, int bits) {
    int64_t s = int64_t(1) << (bits - 1);
    return (v ^ s) - s;
}

inline int unquantize_unsigned(int v, int w) {
    if (w >= 16) return v;
    int maxv = (1 << w) - 1;
    if (v == 0) return 0;
    if (v >= maxv) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (w - 1);
}

// Signed unquantize (D3D11.3 §19.5.11.3): magnitude path saturating at
// the (w-1)-bit max to +/-0x7FFF.
inline int unquantize_signed(int v, int w) {
    if (w >= 16) return v;
    int s = v < 0 ? -1 : 1;
    int av = v < 0 ? -v : v;
    int maxv = (1 << (w - 1)) - 1;
    int o;
    if (av == 0) o = 0;
    else if (av >= maxv) o = 0x7FFF;
    else o = ((av << 15) + 0x4000) >> (w - 1);
    return s * o;
}

void decode_bc6h_block(const uint8_t* block, uint16_t* out /*16*3 half bits*/,
                       bool signed_fmt = false) {
    int code = (block[0] & 2) ? (block[0] & 0x1F) : (block[0] & 3);
    Bc6Mode m;
    if (!bc6_mode_of(code, &m)) {
        std::memset(out, 0, 16 * 3 * sizeof(uint16_t));
        return;
    }
    BitReader br(block);
    br.get((block[0] & 2) ? 5 : 2);

    int64_t fields[13] = {};
    for (const Op* op = m.ops; op->field != END; ++op) {
        if (op->hi >= op->lo) {
            fields[op->field] |= int64_t(br.get(op->hi - op->lo + 1)) << op->lo;
        } else {
            fields[op->field] |= int64_t(br.get_reversed(op->lo - op->hi + 1)) << op->hi;
        }
    }
    int64_t mask = (int64_t(1) << m.epb) - 1;
    if (signed_fmt) {
        // Signed endpoints are two's complement at the storage width;
        // delta bases always, and every endpoint for non-delta modes.
        for (int c = 0; c < 3; ++c) {
            fields[RW + c] = sign_extend(fields[RW + c], m.epb);
            if (!m.dr) {
                for (int e = 1; e < 4; ++e)
                    fields[RW + c + e * 3] = sign_extend(fields[RW + c + e * 3], m.epb);
            }
        }
    }
    if (m.dr) {
        const int dbits[3] = {m.dr, m.dg, m.db};
        for (int c = 0; c < 3; ++c) {
            int64_t base = fields[RW + c];
            for (int e = 1; e < 4; ++e) {
                int64_t* slot = &fields[RW + c + e * 3];
                int64_t s = (base + sign_extend(*slot, dbits[c])) & mask;
                *slot = signed_fmt ? sign_extend(s, m.epb) : s;
            }
        }
    }
    int uq[12];
    for (int k = 0; k < 12; ++k)
        uq[k] = signed_fmt ? unquantize_signed(int(fields[k]), m.epb)
                           : unquantize_unsigned(int(fields[k]), m.epb);

    int partition = m.two ? int(fields[D]) : 0;
    int ib = m.two ? 3 : 4;
    const int* weights = m.two ? kWeights3 : kWeights4;

    int idx[16];
    for (int i = 0; i < 16; ++i) {
        bool anchor = (i == 0) || (m.two && g_anchor2[partition] == i);
        idx[i] = int(br.get(ib - (anchor ? 1 : 0)));
    }
    for (int i = 0; i < 16; ++i) {
        int region = m.two ? g_partitions2[partition][i] : 0;
        int w = weights[idx[i]];
        for (int c = 0; c < 3; ++c) {
            int a = uq[c + region * 6];      // (RW,GW,BW) / (RY,GY,BY)
            int b = uq[3 + c + region * 6];  // (RX,GX,BX) / (RZ,GZ,BZ)
            int v = interp(a, b, w);
            if (signed_fmt) {
                // Scale magnitude by 31/32; sign-magnitude half bits.
                int mag = ((v < 0 ? -v : v) * 31) >> 5;
                out[i * 3 + c] = uint16_t(v < 0 ? (0x8000 | mag) : mag);
            } else {
                out[i * 3 + c] = uint16_t((v * 31) >> 6);
            }
        }
    }
}

}  // namespace

extern "C" {

void bc7_init(const int32_t* p2, const int32_t* p3, const int32_t* a2,
              const int32_t* a3s, const int32_t* a3t) {
    for (int p = 0; p < 64; ++p) {
        for (int i = 0; i < 16; ++i) {
            g_partitions2[p][i] = int8_t(p2[p * 16 + i]);
            g_partitions3[p][i] = int8_t(p3[p * 16 + i]);
        }
        g_anchor2[p] = int8_t(a2[p]);
        g_anchor3_second[p] = int8_t(a3s[p]);
        g_anchor3_third[p] = int8_t(a3t[p]);
    }
}

void decode_bc7(const uint8_t* blocks, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) decode_bc7_block(blocks + i * 16, out + i * 64);
}

void decode_bc4(const uint8_t* blocks, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) decode_bc4_block(blocks + i * 8, out + i * 16);
}

void decode_bc6h(const uint8_t* blocks, int64_t n, uint16_t* out) {
    for (int64_t i = 0; i < n; ++i) decode_bc6h_block(blocks + i * 16, out + i * 48);
}

void decode_bc6h_sf(const uint8_t* blocks, int64_t n, uint16_t* out) {
    for (int64_t i = 0; i < n; ++i)
        decode_bc6h_block(blocks + i * 16, out + i * 48, /*signed_fmt=*/true);
}

}  // extern "C"

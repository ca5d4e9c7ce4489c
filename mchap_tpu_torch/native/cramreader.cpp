// Native CRAM 3.0 decoder: decodes CRAM containers into the same
// columnar record arrays as the BAM decoder (records.h), so the Python
// layer handles both formats through one interface.
//
// The reference delegates CRAM to htslib (via pysam, mchap/io/bam.py:41
// opens AlignmentFile(path, reference_filename=...)); this framework is
// standalone, so the container walk, block codecs (raw/gzip/rANS-4x8),
// the encoding table (EXTERNAL / HUFFMAN / BETA / BYTE_ARRAY_LEN /
// BYTE_ARRAY_STOP), and reference-based sequence reconstruction are
// implemented here against the CRAM 3.0 specification.
//
// Scope: decoding only, CRAM v3.0 (what htslib writes by default).
// Unsupported codecs/encodings fail with a clear g_bam_error message so
// the caller can report the limitation instead of mis-decoding.
//
// C API: cram_load(path, fasta_path) -> BamData* (shares bam_* accessors).

#include <zlib.h>

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#include "records.h"

namespace {

std::string& g_error = g_bam_error;

// ---------------------------------------------------------------------------
// byte cursor + ITF8 / LTF8 varints (CRAM spec §2.3)
// ---------------------------------------------------------------------------

struct Cursor {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    uint8_t u8() {
        if (p >= end) {
            ok = false;
            return 0;
        }
        return *p++;
    }
    void bytes(void* dst, size_t n) {
        if (p + n > end) {
            ok = false;
            memset(dst, 0, n);
            return;
        }
        memcpy(dst, p, n);
        p += n;
    }
    uint32_t u32le() {
        uint8_t b[4];
        bytes(b, 4);
        return (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
               ((uint32_t)b[3] << 24);
    }
    int32_t itf8() {
        uint32_t c0 = u8();
        if (!(c0 & 0x80)) return (int32_t)c0;
        if (!(c0 & 0x40)) return (int32_t)(((c0 & 0x3F) << 8) | u8());
        if (!(c0 & 0x20)) {
            uint32_t v = (c0 & 0x1F) << 16;
            v |= (uint32_t)u8() << 8;
            v |= u8();
            return (int32_t)v;
        }
        if (!(c0 & 0x10)) {
            uint32_t v = (c0 & 0x0F) << 24;
            v |= (uint32_t)u8() << 16;
            v |= (uint32_t)u8() << 8;
            v |= u8();
            return (int32_t)v;
        }
        uint32_t v = (c0 & 0x0F) << 28;
        v |= (uint32_t)u8() << 20;
        v |= (uint32_t)u8() << 12;
        v |= (uint32_t)u8() << 4;
        v |= u8() & 0x0F;
        return (int32_t)v;
    }
    int64_t ltf8() {
        uint64_t c0 = u8();
        int extra = 0;
        for (int i = 0; i < 8; i++) {
            if (c0 & (0x80ull >> i))
                extra++;
            else
                break;
        }
        uint64_t v = (extra < 8) ? (c0 & (0xFFull >> extra)) : 0;
        for (int i = 0; i < extra; i++) v = (v << 8) | u8();
        return (int64_t)v;
    }
};

// ---------------------------------------------------------------------------
// block codecs
// ---------------------------------------------------------------------------

bool inflate_gzip(const uint8_t* src, size_t n, size_t raw_size,
                  std::string& out) {
    out.resize(raw_size);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 32) != Z_OK) {  // gzip or zlib wrapper
        g_error = "inflateInit2 failed";
        return false;
    }
    zs.next_in = const_cast<uint8_t*>(src);
    zs.avail_in = (uInt)n;
    zs.next_out = (uint8_t*)out.data();
    zs.avail_out = (uInt)raw_size;
    int ret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (ret != Z_STREAM_END) {
        g_error = "cram: gzip block inflate failed";
        return false;
    }
    return true;
}

// rANS 4x8 static codec (CRAM spec §13; 12-bit frequencies, 4
// interleaved states, byte renormalisation at 2^23).
constexpr uint32_t RANS_L = 1u << 23;
constexpr uint32_t TF_SHIFT = 12;
constexpr uint32_t TOTFREQ = 1u << TF_SHIFT;

struct RansTable {
    uint32_t freq[256] = {0};
    uint32_t cum[257] = {0};
    uint8_t sym_of[TOTFREQ];

    bool finish() {
        uint32_t c = 0;
        for (int s = 0; s < 256; s++) {
            cum[s] = c;
            c += freq[s];
        }
        cum[256] = c;
        if (c == 0 || c > TOTFREQ) {
            g_error = "cram: rans frequency table does not sum to 4096";
            return false;
        }
        // spec allows sum < 4096 only via implicit renorm in writers;
        // htslib always writes exactly 4096 — map the table directly.
        for (int s = 0; s < 256; s++)
            for (uint32_t i = cum[s]; i < cum[s] + freq[s]; i++) sym_of[i] = s;
        // fill any tail (defensive) with last symbol
        for (uint32_t i = c; i < TOTFREQ; i++) sym_of[i] = 255;
        return true;
    }
};

// run-length encoded symbol list shared by the O0 table and each O1 row
template <typename PerSymbol>
bool read_rans_symbols(Cursor& c, PerSymbol f) {
    int rle = 0;
    int j = c.u8();
    do {
        f(j, c);
        if (!c.ok) return false;
        if (rle > 0) {
            rle--;
            j++;
        } else {
            int nj = c.u8();
            if (nj == j + 1) rle = c.u8();
            j = nj;
        }
    } while (j != 0);
    return c.ok;
}

inline void rans_renorm(uint32_t& x, Cursor& c) {
    while (x < RANS_L) x = (x << 8) | c.u8();
}

bool rans_uncompress(const uint8_t* src, size_t n, size_t raw_size,
                     std::string& out) {
    Cursor c{src, src + n};
    int order = c.u8();
    (void)c.u32le();  // compressed size of the stream body
    uint32_t out_sz = c.u32le();
    if (out_sz != raw_size) {
        g_error = "cram: rans raw size mismatch";
        return false;
    }
    out.resize(out_sz);
    if (out_sz == 0) return true;

    if (order == 0) {
        RansTable t;
        if (!read_rans_symbols(
                c, [&](int j, Cursor& cc) { t.freq[j] = cc.itf8(); }))
            return false;
        if (!t.finish()) return false;
        uint32_t R[4];
        for (int k = 0; k < 4; k++) R[k] = c.u32le();
        size_t i = 0;
        for (; i + 4 <= out_sz; i += 4) {
            for (int k = 0; k < 4; k++) {
                uint32_t m = R[k] & (TOTFREQ - 1);
                uint8_t s = t.sym_of[m];
                out[i + k] = (char)s;
                R[k] = t.freq[s] * (R[k] >> TF_SHIFT) + m - t.cum[s];
                rans_renorm(R[k], c);
            }
        }
        for (int k = 0; i < out_sz; i++, k++) {
            uint32_t m = R[k] & (TOTFREQ - 1);
            uint8_t s = t.sym_of[m];
            out[i] = (char)s;
            R[k] = t.freq[s] * (R[k] >> TF_SHIFT) + m - t.cum[s];
            rans_renorm(R[k], c);
        }
        return c.ok;
    }
    if (order == 1) {
        auto tables = std::make_unique<RansTable[]>(256);
        bool sub_ok = true;
        if (!read_rans_symbols(c, [&](int i, Cursor& cc) {
                sub_ok = sub_ok && read_rans_symbols(cc, [&](int j, Cursor& c2) {
                             tables[i].freq[j] = c2.itf8();
                         }) &&
                         tables[i].finish();
            }))
            return false;
        if (!sub_ok) return false;
        uint32_t R[4];
        for (int k = 0; k < 4; k++) R[k] = c.u32le();
        size_t q = out_sz >> 2;
        size_t idx[4] = {0, q, 2 * q, 3 * q};
        uint8_t ctx[4] = {0, 0, 0, 0};
        for (size_t step = 0; step < q; step++) {
            for (int k = 0; k < 4; k++) {
                RansTable& t = tables[ctx[k]];
                uint32_t m = R[k] & (TOTFREQ - 1);
                uint8_t s = t.sym_of[m];
                out[idx[k]] = (char)s;
                R[k] = t.freq[s] * (R[k] >> TF_SHIFT) + m - t.cum[s];
                rans_renorm(R[k], c);
                ctx[k] = s;
                idx[k]++;
            }
        }
        for (; idx[3] < out_sz; idx[3]++) {
            RansTable& t = tables[ctx[3]];
            uint32_t m = R[3] & (TOTFREQ - 1);
            uint8_t s = t.sym_of[m];
            out[idx[3]] = (char)s;
            R[3] = t.freq[s] * (R[3] >> TF_SHIFT) + m - t.cum[s];
            rans_renorm(R[3], c);
            ctx[3] = s;
        }
        return c.ok;
    }
    g_error = "cram: unsupported rans order";
    return false;
}

// ---------------------------------------------------------------------------
// blocks and containers
// ---------------------------------------------------------------------------

struct Block {
    int method = 0;
    int content_type = 0;
    int content_id = 0;
    std::string data;  // uncompressed
};

bool read_block(Cursor& c, Block& b) {
    b.method = c.u8();
    b.content_type = c.u8();
    b.content_id = c.itf8();
    int32_t csize = c.itf8();
    int32_t rsize = c.itf8();
    if (!c.ok || csize < 0 || rsize < 0 || c.p + csize > c.end) {
        g_error = "cram: truncated block";
        return false;
    }
    const uint8_t* src = c.p;
    c.p += csize;
    // skip CRC32
    if (c.p + 4 > c.end) {
        g_error = "cram: truncated block crc";
        return false;
    }
    c.p += 4;
    switch (b.method) {
        case 0:  // raw
            b.data.assign((const char*)src, csize);
            return true;
        case 1:  // gzip
            return inflate_gzip(src, csize, rsize, b.data);
        case 4:  // rANS 4x8
            return rans_uncompress(src, csize, rsize, b.data);
        default:
            g_error = "cram: unsupported block compression method " +
                      std::to_string(b.method);
            return false;
    }
}

struct ContainerHeader {
    int32_t length = 0;
    int32_t ref_id = 0;
    int32_t start = 0;
    int32_t span = 0;
    int32_t n_records = 0;
    int64_t counter = 0;
    int64_t n_bases = 0;
    int32_t n_blocks = 0;
    std::vector<int32_t> landmarks;
};

bool read_container_header(Cursor& c, ContainerHeader& h) {
    h.length = (int32_t)c.u32le();
    h.ref_id = c.itf8();
    h.start = c.itf8();
    h.span = c.itf8();
    h.n_records = c.itf8();
    h.counter = c.ltf8();
    h.n_bases = c.ltf8();
    h.n_blocks = c.itf8();
    int32_t nl = c.itf8();
    h.landmarks.resize(nl > 0 ? nl : 0);
    for (auto& l : h.landmarks) l = c.itf8();
    c.p += 4;  // CRC32
    return c.ok;
}

// ---------------------------------------------------------------------------
// encodings (CRAM spec §12)
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint32_t bitpos = 0;
    bool ok = true;

    uint32_t bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) {
            size_t byte = bitpos >> 3;
            if (p + byte >= end) {
                ok = false;
                return v;
            }
            v = (v << 1) | ((p[byte] >> (7 - (bitpos & 7))) & 1);
            bitpos++;
        }
        return v;
    }
};

struct Encoding;
struct DecodeCtx {
    std::unordered_map<int, Cursor> external;  // content id -> cursor
    BitReader core{nullptr, nullptr};
};

struct Encoding {
    int codec = 0;  // 0 NULL, 1 EXTERNAL, 3 HUFFMAN, 4 B.A.LEN, 5 B.A.STOP, 6 BETA
    // EXTERNAL / BYTE_ARRAY_STOP
    int content_id = 0;
    uint8_t stop_byte = 0;
    // HUFFMAN (canonical): codes sorted by (length, symbol order given)
    std::vector<int32_t> h_syms;
    std::vector<int32_t> h_lens;
    std::vector<uint32_t> h_codes;
    // BETA
    int32_t beta_offset = 0;
    int32_t beta_len = 0;
    // BYTE_ARRAY_LEN (shared_ptr so Encoding stays copyable)
    std::shared_ptr<Encoding> len_enc, val_enc;

    bool build_huffman() {
        // canonical code assignment per CRAM spec: sort by length then
        // by order of appearance
        struct Item {
            int32_t sym, len;
            size_t order;
        };
        std::vector<Item> items;
        for (size_t i = 0; i < h_syms.size(); i++)
            items.push_back({h_syms[i], h_lens[i], i});
        std::stable_sort(items.begin(), items.end(),
                         [](const Item& a, const Item& b) {
                             return a.len < b.len;
                         });
        h_codes.assign(h_syms.size(), 0);
        uint32_t code = 0;
        int32_t last_len = items.empty() ? 0 : items[0].len;
        for (size_t i = 0; i < items.size(); i++) {
            if (i > 0) {
                code++;
                if (items[i].len > last_len) {
                    code <<= (items[i].len - last_len);
                    last_len = items[i].len;
                }
            }
            h_codes[items[i].order] = code;
        }
        return true;
    }

    // decode one integer value
    int32_t decode_int(DecodeCtx& ctx, bool& ok) const {
        switch (codec) {
            case 1: {
                auto it = ctx.external.find(content_id);
                if (it == ctx.external.end()) {
                    ok = false;
                    return 0;
                }
                return it->second.itf8();
            }
            case 3: {
                if (h_syms.size() == 1 && h_lens[0] == 0) return h_syms[0];
                // walk the canonical code bit by bit
                uint32_t code = 0;
                int len = 0;
                for (int guard = 0; guard < 32; guard++) {
                    code = (code << 1) | ctx.core.bits(1);
                    len++;
                    for (size_t i = 0; i < h_syms.size(); i++)
                        if (h_lens[i] == len && h_codes[i] == code)
                            return h_syms[i];
                    if (!ctx.core.ok) break;
                }
                ok = false;
                return 0;
            }
            case 6:
                return (int32_t)ctx.core.bits(beta_len) - beta_offset;
            default:
                ok = false;
                return 0;
        }
    }

    // decode one byte value
    uint8_t decode_byte(DecodeCtx& ctx, bool& ok) const {
        switch (codec) {
            case 1: {
                auto it = ctx.external.find(content_id);
                if (it == ctx.external.end()) {
                    ok = false;
                    return 0;
                }
                return it->second.u8();
            }
            case 3:
                if (h_syms.size() == 1 && h_lens[0] == 0)
                    return (uint8_t)h_syms[0];
                return (uint8_t)decode_int(ctx, ok);
            default:
                return (uint8_t)decode_int(ctx, ok);
        }
    }

    // decode a byte array
    bool decode_bytes(DecodeCtx& ctx, std::string& out) const {
        bool ok = true;
        switch (codec) {
            case 4: {  // BYTE_ARRAY_LEN
                int32_t n = len_enc->decode_int(ctx, ok);
                if (!ok || n < 0) return false;
                out.reserve(out.size() + n);
                for (int32_t i = 0; i < n; i++)
                    out.push_back((char)val_enc->decode_byte(ctx, ok));
                return ok;
            }
            case 5: {  // BYTE_ARRAY_STOP
                auto it = ctx.external.find(content_id);
                if (it == ctx.external.end()) return false;
                Cursor& cc = it->second;
                while (cc.p < cc.end) {
                    uint8_t b = cc.u8();
                    if (b == stop_byte) return true;
                    out.push_back((char)b);
                }
                return false;
            }
            default:
                return false;
        }
    }

    // decode exactly n bytes (for sequences / quality runs)
    bool decode_n_bytes(DecodeCtx& ctx, int32_t n, std::string& out) const {
        bool ok = true;
        if (codec == 1) {
            auto it = ctx.external.find(content_id);
            if (it == ctx.external.end()) return false;
            Cursor& cc = it->second;
            if (cc.p + n > cc.end) return false;
            out.append((const char*)cc.p, n);
            cc.p += n;
            return true;
        }
        for (int32_t i = 0; i < n; i++)
            out.push_back((char)decode_byte(ctx, ok));
        return ok;
    }
};

bool parse_encoding(Cursor& c, Encoding& e);

bool parse_encoding_args(int codec, Cursor a, Encoding& e) {
    e.codec = codec;
    switch (codec) {
        case 0:  // NULL
            return true;
        case 1:  // EXTERNAL
            e.content_id = a.itf8();
            return a.ok;
        case 3: {  // HUFFMAN
            int32_t n = a.itf8();
            e.h_syms.resize(n > 0 ? n : 0);
            for (auto& s : e.h_syms) s = a.itf8();
            int32_t m = a.itf8();
            e.h_lens.resize(m > 0 ? m : 0);
            for (auto& l : e.h_lens) l = a.itf8();
            if (e.h_syms.size() != e.h_lens.size()) return false;
            e.build_huffman();
            return a.ok;
        }
        case 4: {  // BYTE_ARRAY_LEN
            e.len_enc = std::make_shared<Encoding>();
            e.val_enc = std::make_shared<Encoding>();
            if (!parse_encoding(a, *e.len_enc)) return false;
            if (!parse_encoding(a, *e.val_enc)) return false;
            return a.ok;
        }
        case 5:  // BYTE_ARRAY_STOP
            e.stop_byte = a.u8();
            e.content_id = a.itf8();
            return a.ok;
        case 6:  // BETA
            e.beta_offset = a.itf8();
            e.beta_len = a.itf8();
            return a.ok;
        default:
            g_error = "cram: unsupported encoding codec " + std::to_string(codec);
            return false;
    }
}

bool parse_encoding(Cursor& c, Encoding& e) {
    int codec = c.itf8();
    int32_t len = c.itf8();
    if (!c.ok || c.p + len > c.end) return false;
    Cursor args{c.p, c.p + len};
    c.p += len;
    return parse_encoding_args(codec, args, e);
}

// ---------------------------------------------------------------------------
// compression header
// ---------------------------------------------------------------------------

struct TagDef {
    char tag[2];
    char type;
    Encoding enc;
};

struct CompressionHeader {
    bool rn_preserved = true;   // RN
    bool ap_delta = true;       // AP
    bool rr_required = true;    // RR (reference required)
    uint8_t sub_matrix[5] = {27, 27, 27, 27, 27};  // SM
    std::vector<std::vector<int>> tag_lines;       // TD -> indices into tags
    std::vector<TagDef> tags;                      // keyed by 3-byte id order
    std::map<int, TagDef> tag_by_key;
    std::map<std::string, Encoding> series;
};

bool parse_compression_header(const std::string& data, CompressionHeader& h) {
    Cursor c{(const uint8_t*)data.data(), (const uint8_t*)data.data() + data.size()};
    // preservation map
    (void)c.itf8();  // size in bytes
    int32_t n = c.itf8();
    for (int32_t i = 0; i < n; i++) {
        char k0 = (char)c.u8(), k1 = (char)c.u8();
        std::string key{k0, k1};
        if (key == "RN")
            h.rn_preserved = c.u8() != 0;
        else if (key == "AP")
            h.ap_delta = c.u8() != 0;
        else if (key == "RR")
            h.rr_required = c.u8() != 0;
        else if (key == "SM")
            for (int j = 0; j < 5; j++) h.sub_matrix[j] = c.u8();
        else if (key == "TD") {
            int32_t len = c.itf8();
            const uint8_t* td = c.p;
            c.p += len;
            // NUL-separated lines of 3-byte tag descriptors
            std::vector<int> line;
            std::map<std::string, int> seen;
            for (int32_t j = 0; j < len; j++) {
                if (td[j] == 0) {
                    h.tag_lines.push_back(line);
                    line.clear();
                } else {
                    std::string t((const char*)td + j, 3);
                    j += 2;
                    auto it = seen.find(t);
                    int idx;
                    if (it == seen.end()) {
                        idx = (int)h.tags.size();
                        TagDef d;
                        d.tag[0] = t[0];
                        d.tag[1] = t[1];
                        d.type = t[2];
                        h.tags.push_back(std::move(d));
                        seen[t] = idx;
                    } else {
                        idx = it->second;
                    }
                    line.push_back(idx);
                }
            }
        } else {
            g_error = "cram: unknown preservation key " + key;
            return false;
        }
    }
    // data series encodings
    (void)c.itf8();
    n = c.itf8();
    for (int32_t i = 0; i < n; i++) {
        char k0 = (char)c.u8(), k1 = (char)c.u8();
        std::string key{k0, k1};
        Encoding e;
        if (!parse_encoding(c, e)) return false;
        h.series[key] = std::move(e);
    }
    // tag encodings
    (void)c.itf8();
    n = c.itf8();
    for (int32_t i = 0; i < n; i++) {
        int32_t key = c.itf8();
        char t0 = (char)((key >> 16) & 0xFF);
        char t1 = (char)((key >> 8) & 0xFF);
        char ty = (char)(key & 0xFF);
        Encoding e;
        if (!parse_encoding(c, e)) return false;
        // attach to the matching TagDef(s)
        for (auto& d : h.tags)
            if (d.tag[0] == t0 && d.tag[1] == t1 && d.type == ty) d.enc = e;
        TagDef d;
        d.tag[0] = t0;
        d.tag[1] = t1;
        d.type = ty;
        d.enc = std::move(e);
        h.tag_by_key[key] = std::move(d);
    }
    return c.ok;
}

// ---------------------------------------------------------------------------
// slice header
// ---------------------------------------------------------------------------

struct SliceHeader {
    int32_t ref_id = 0;
    int32_t start = 0;
    int32_t span = 0;
    int32_t n_records = 0;
    int64_t counter = 0;
    int32_t n_blocks = 0;
    std::vector<int32_t> content_ids;
    int32_t embedded_ref_id = -1;
    uint8_t md5[16] = {0};
};

bool parse_slice_header(const std::string& data, SliceHeader& s) {
    Cursor c{(const uint8_t*)data.data(), (const uint8_t*)data.data() + data.size()};
    s.ref_id = c.itf8();
    s.start = c.itf8();
    s.span = c.itf8();
    s.n_records = c.itf8();
    s.counter = c.ltf8();
    s.n_blocks = c.itf8();
    int32_t n = c.itf8();
    s.content_ids.resize(n > 0 ? n : 0);
    for (auto& id : s.content_ids) id = c.itf8();
    s.embedded_ref_id = c.itf8();
    c.bytes(s.md5, 16);
    return c.ok;
}

// ---------------------------------------------------------------------------
// FASTA reference
// ---------------------------------------------------------------------------

bool load_fasta(const char* path, std::map<std::string, std::string>& out) {
    FILE* f = fopen(path, "rb");
    if (!f) {
        g_error = std::string("cram: cannot open reference fasta ") + path;
        return false;
    }
    std::string name, seq;
    char buf[1 << 16];
    std::string carry;
    auto flush = [&]() {
        if (!name.empty()) out[name] = std::move(seq);
        seq.clear();
    };
    while (fgets(buf, sizeof(buf), f)) {
        size_t n = strlen(buf);
        while (n && (buf[n - 1] == '\n' || buf[n - 1] == '\r')) buf[--n] = 0;
        if (buf[0] == '>') {
            flush();
            // name = text up to first whitespace
            const char* sp = strchr(buf + 1, ' ');
            const char* tb = strchr(buf + 1, '\t');
            const char* e = buf + 1 + strlen(buf + 1);
            if (sp && sp < e) e = sp;
            if (tb && tb < e) e = tb;
            name.assign(buf + 1, e - (buf + 1));
        } else {
            for (size_t i = 0; i < n; i++) seq.push_back(toupper(buf[i]));
        }
    }
    flush();
    fclose(f);
    return true;
}

// substitution matrix decode: for reference base r (index into "ACGTN"),
// SM byte packs 2-bit codes of the four substitute bases in alphabetical
// order; BS code c selects the substitute whose packed code equals c.
const char BASES[6] = "ACGTN";

int base_index(char b) {
    switch (b) {
        case 'A': return 0;
        case 'C': return 1;
        case 'G': return 2;
        case 'T': return 3;
        default: return 4;
    }
}

char substitute_base(const uint8_t* sm, char ref_base, int code) {
    int r = base_index(ref_base);
    uint8_t byte = sm[r];
    int k = 0;
    for (int i = 0; i < 5; i++) {
        if (i == r) continue;
        int c = (byte >> (6 - 2 * k)) & 3;
        if (k < 4 && c == code) return BASES[i];
        k++;
        if (k == 4) break;
    }
    return 'N';
}

// ---------------------------------------------------------------------------
// record decoding
// ---------------------------------------------------------------------------

struct CramContext {
    CompressionHeader comp;
    std::map<std::string, std::string>* fasta = nullptr;
    std::vector<std::string>* ref_names = nullptr;
    std::vector<std::string> rg_ids;  // @RG ID strings in header order
};

const Encoding* get_series(const CompressionHeader& h, const char* key) {
    auto it = h.series.find(key);
    return it == h.series.end() ? nullptr : &it->second;
}

#define NEED(series_ptr, name)                                          \
    if (!(series_ptr)) {                                                \
        g_error = std::string("cram: missing data series ") + (name);   \
        return false;                                                   \
    }

bool decode_slice(BamData* bam, CramContext& cx, const SliceHeader& sh,
                  const Block& core, const std::map<int, const Block*>& ext,
                  const std::string* embedded_ref) {
    const CompressionHeader& ch = cx.comp;
    DecodeCtx ctx;
    ctx.core.p = (const uint8_t*)core.data.data();
    ctx.core.end = ctx.core.p + core.data.size();
    for (auto& [cid, blk] : ext)
        ctx.external.emplace(
            cid, Cursor{(const uint8_t*)blk->data.data(),
                        (const uint8_t*)blk->data.data() + blk->data.size()});

    const Encoding* BF = get_series(ch, "BF");
    const Encoding* CF = get_series(ch, "CF");
    const Encoding* RI = get_series(ch, "RI");
    const Encoding* RL = get_series(ch, "RL");
    const Encoding* AP = get_series(ch, "AP");
    const Encoding* RG = get_series(ch, "RG");
    const Encoding* RN = get_series(ch, "RN");
    const Encoding* MF = get_series(ch, "MF");
    const Encoding* NS = get_series(ch, "NS");
    const Encoding* NP = get_series(ch, "NP");
    const Encoding* TS = get_series(ch, "TS");
    const Encoding* NF = get_series(ch, "NF");
    const Encoding* TL = get_series(ch, "TL");
    const Encoding* FN = get_series(ch, "FN");
    const Encoding* FC = get_series(ch, "FC");
    const Encoding* FP = get_series(ch, "FP");
    const Encoding* BS = get_series(ch, "BS");
    const Encoding* IN = get_series(ch, "IN");
    const Encoding* SC = get_series(ch, "SC");
    const Encoding* BB = get_series(ch, "BB");
    const Encoding* QQ = get_series(ch, "QQ");
    const Encoding* DL = get_series(ch, "DL");
    const Encoding* RS = get_series(ch, "RS");
    const Encoding* PD = get_series(ch, "PD");
    const Encoding* HC = get_series(ch, "HC");
    const Encoding* BA = get_series(ch, "BA");
    const Encoding* MQ = get_series(ch, "MQ");
    const Encoding* QS = get_series(ch, "QS");
    NEED(BF, "BF");
    NEED(CF, "CF");
    NEED(RL, "RL");
    NEED(AP, "AP");
    NEED(RG, "RG");

    int32_t last_ap = sh.start;
    bool ok = true;

    for (int32_t rec = 0; rec < sh.n_records; rec++) {
        int32_t bf = BF->decode_int(ctx, ok);
        int32_t cf = CF->decode_int(ctx, ok);
        int32_t ref_id = sh.ref_id;
        if (sh.ref_id == -2) {
            NEED(RI, "RI");
            ref_id = RI->decode_int(ctx, ok);
        }
        int32_t rl = RL->decode_int(ctx, ok);
        int32_t ap = AP->decode_int(ctx, ok);
        if (ch.ap_delta) {
            ap = last_ap + ap;
            last_ap = ap;
        }
        int32_t rg = RG->decode_int(ctx, ok);

        std::string qname;
        if (ch.rn_preserved) {
            NEED(RN, "RN");
            if (!RN->decode_bytes(ctx, qname)) {
                g_error = "cram: read name decode failed";
                return false;
            }
        }
        int32_t mf = 0, ns = -1, np = 0, ts = 0, nf = 0;
        bool detached = (cf & 0x2) != 0;
        bool mate_downstream = (cf & 0x4) != 0;
        if (detached) {
            NEED(MF, "MF");
            mf = MF->decode_int(ctx, ok);
            if (!ch.rn_preserved) {
                NEED(RN, "RN");
                if (!RN->decode_bytes(ctx, qname)) return false;
            }
            NEED(NS, "NS");
            NEED(NP, "NP");
            NEED(TS, "TS");
            ns = NS->decode_int(ctx, ok);
            np = NP->decode_int(ctx, ok);
            ts = TS->decode_int(ctx, ok);
            (void)ns;
            (void)np;
            (void)ts;
        } else if (mate_downstream) {
            NEED(NF, "NF");
            nf = NF->decode_int(ctx, ok);
            (void)nf;
        }
        if (qname.empty())
            qname = "cram_" + std::to_string(bam->refid.size());

        // tags
        std::string aux;
        bool had_md = false;
        NEED(TL, "TL");
        int32_t tl = TL->decode_int(ctx, ok);
        if (tl < 0 || (size_t)tl > ch.tag_lines.size()) {
            g_error = "cram: bad tag line index";
            return false;
        }
        if ((size_t)tl < ch.tag_lines.size()) {
            for (int tag_idx : ch.tag_lines[tl]) {
                const TagDef& d = ch.tags[tag_idx];
                std::string val;
                if (!d.enc.decode_bytes(ctx, val)) {
                    // single-value encodings
                    bool ok2 = true;
                    val.push_back((char)d.enc.decode_byte(ctx, ok2));
                    if (!ok2) {
                        g_error = "cram: tag decode failed";
                        return false;
                    }
                }
                if (d.tag[0] == 'M' && d.tag[1] == 'D') had_md = true;
                aux.push_back(d.tag[0]);
                aux.push_back(d.tag[1]);
                aux.push_back(d.type);
                aux.append(val);
                // CRAM stores Z/H values WITH their NUL terminator
                if ((d.type == 'Z' || d.type == 'H') &&
                    (val.empty() || val.back() != '\0'))
                    aux.push_back('\0');
            }
        }
        // read group tag
        if (rg >= 0 && (size_t)rg < cx.rg_ids.size()) {
            aux.push_back('R');
            aux.push_back('G');
            aux.push_back('Z');
            aux.append(cx.rg_ids[rg]);
            aux.push_back('\0');
        }

        std::string seq, quals;
        std::vector<uint32_t> cigar;
        int32_t mapq = 0;

        bool unmapped = (bf & 0x4) != 0;
        if (!unmapped) {
            NEED(FN, "FN");
            NEED(FC, "FC");
            NEED(FP, "FP");
            int32_t fn = FN->decode_int(ctx, ok);

            // reference slice for this read
            const std::string* ref_seq = embedded_ref;
            int64_t ref_off0 = 0;  // offset of embedded ref start
            std::string ref_local;
            if (!ref_seq) {
                if (!cx.fasta) {
                    g_error = "cram: reference fasta required to decode "
                              "mapped CRAM records (pass reference_filename)";
                    return false;
                }
                if (ref_id < 0 || (size_t)ref_id >= cx.ref_names->size()) {
                    g_error = "cram: record ref id out of range";
                    return false;
                }
                auto it = cx.fasta->find((*cx.ref_names)[ref_id]);
                if (it == cx.fasta->end()) {
                    g_error = "cram: contig " + (*cx.ref_names)[ref_id] +
                              " not present in reference fasta";
                    return false;
                }
                ref_seq = &it->second;
            } else {
                ref_off0 = sh.start - 1;  // embedded ref starts at slice start
            }

            auto ref_base = [&](int64_t pos0) -> char {
                int64_t i = pos0 - ref_off0;
                if (i < 0 || (size_t)i >= ref_seq->size()) return 'N';
                return (char)toupper((*ref_seq)[i]);
            };

            // feature walk: build seq + cigar (+ MD reconstruction,
            // htslib strips reconstructable MD tags from CRAM and
            // regenerates them on decode — pysam parity)
            seq.reserve(rl);
            int32_t read_i = 0;       // bases emitted
            int64_t ref_i = ap - 1;   // 0-based reference cursor
            int32_t prev_fp = 0;
            uint32_t pending_m = 0;
            std::string md;
            int32_t md_run = 0;
            auto push_op = [&](uint32_t len, uint32_t op) {
                if (len == 0) return;
                if (!cigar.empty() && (cigar.back() & 0xF) == op)
                    cigar.back() += len << 4;
                else
                    cigar.push_back((len << 4) | op);
            };
            auto emit_match = [&](int32_t upto) {
                // copy reference bases for read positions [read_i, upto)
                while (read_i < upto) {
                    seq.push_back(ref_base(ref_i));
                    read_i++;
                    ref_i++;
                    pending_m++;
                    md_run++;
                }
            };
            bool feat_ok = true;
            for (int32_t f = 0; f < fn && feat_ok; f++) {
                uint8_t fc = FC->decode_byte(ctx, ok);
                int32_t fp = FP->decode_int(ctx, ok);
                int32_t pos1 = prev_fp + fp;  // 1-based read position
                prev_fp = pos1;
                emit_match(pos1 - 1);
                switch ((char)fc) {
                    case 'X': {  // substitution
                        NEED(BS, "BS");
                        int code = BS->decode_byte(ctx, ok);
                        char rb = ref_base(ref_i);
                        seq.push_back(substitute_base(ch.sub_matrix, rb, code));
                        read_i++;
                        ref_i++;
                        pending_m++;
                        md += std::to_string(md_run);
                        md.push_back(rb);
                        md_run = 0;
                        break;
                    }
                    case 'B': {  // base + qual (read base given explicitly)
                        NEED(BA, "BA");
                        NEED(QS, "QS");
                        char b = (char)BA->decode_byte(ctx, ok);
                        (void)QS->decode_byte(ctx, ok);  // qual re-read below
                        char rb = ref_base(ref_i);
                        seq.push_back(b);
                        read_i++;
                        ref_i++;
                        pending_m++;
                        if (toupper(b) == rb) {
                            md_run++;
                        } else {
                            md += std::to_string(md_run);
                            md.push_back(rb);
                            md_run = 0;
                        }
                        break;
                    }
                    case 'I': {  // insertion
                        NEED(IN, "IN");
                        std::string ins;
                        if (!IN->decode_bytes(ctx, ins)) return false;
                        push_op(pending_m, 0);
                        pending_m = 0;
                        push_op(ins.size(), 1);
                        seq.append(ins);
                        read_i += ins.size();
                        break;
                    }
                    case 'i': {  // single-base insertion
                        NEED(BA, "BA");
                        push_op(pending_m, 0);
                        pending_m = 0;
                        push_op(1, 1);
                        seq.push_back((char)BA->decode_byte(ctx, ok));
                        read_i++;
                        break;
                    }
                    case 'D': {  // deletion
                        NEED(DL, "DL");
                        int32_t dl = DL->decode_int(ctx, ok);
                        push_op(pending_m, 0);
                        pending_m = 0;
                        push_op(dl, 2);
                        md += std::to_string(md_run);
                        md.push_back('^');
                        for (int32_t d2 = 0; d2 < dl; d2++)
                            md.push_back(ref_base(ref_i + d2));
                        md_run = 0;
                        ref_i += dl;
                        break;
                    }
                    case 'N': {  // reference skip
                        NEED(RS, "RS");
                        int32_t sk = RS->decode_int(ctx, ok);
                        push_op(pending_m, 0);
                        pending_m = 0;
                        push_op(sk, 3);
                        ref_i += sk;
                        break;
                    }
                    case 'S': {  // soft clip
                        NEED(SC, "SC");
                        std::string sc;
                        if (!SC->decode_bytes(ctx, sc)) return false;
                        push_op(pending_m, 0);
                        pending_m = 0;
                        push_op(sc.size(), 4);
                        seq.append(sc);
                        read_i += sc.size();
                        break;
                    }
                    case 'H': {  // hard clip
                        NEED(HC, "HC");
                        int32_t hc = HC->decode_int(ctx, ok);
                        push_op(pending_m, 0);
                        pending_m = 0;
                        push_op(hc, 5);
                        break;
                    }
                    case 'P': {  // padding
                        NEED(PD, "PD");
                        int32_t pd = PD->decode_int(ctx, ok);
                        push_op(pending_m, 0);
                        pending_m = 0;
                        push_op(pd, 6);
                        break;
                    }
                    case 'b': {  // stretch of bases
                        NEED(BB, "BB");
                        std::string bb;
                        if (!BB->decode_bytes(ctx, bb)) return false;
                        for (size_t k = 0; k < bb.size(); k++) {
                            char rb = ref_base(ref_i + k);
                            if (toupper(bb[k]) == rb) {
                                md_run++;
                            } else {
                                md += std::to_string(md_run);
                                md.push_back(rb);
                                md_run = 0;
                            }
                        }
                        seq.append(bb);
                        read_i += bb.size();
                        ref_i += bb.size();
                        pending_m += bb.size();
                        break;
                    }
                    case 'q': {  // stretch of quality scores
                        NEED(QQ, "QQ");
                        std::string qq;
                        if (!QQ->decode_bytes(ctx, qq)) return false;
                        // scores only; applied via the QS array below
                        break;
                    }
                    case 'Q': {  // single quality score
                        NEED(QS, "QS");
                        (void)QS->decode_byte(ctx, ok);
                        break;
                    }
                    default:
                        g_error = std::string("cram: unsupported feature code ") +
                                  (char)fc;
                        return false;
                }
            }
            emit_match(rl);
            push_op(pending_m, 0);
            pending_m = 0;
            md += std::to_string(md_run);
            // synthesize the MD tag when the container did not store one
            if (!had_md) {
                aux.push_back('M');
                aux.push_back('D');
                aux.push_back('Z');
                aux.append(md);
                aux.push_back('\0');
            }

            NEED(MQ, "MQ");
            mapq = MQ->decode_int(ctx, ok);
            if (cf & 0x1) {
                NEED(QS, "QS");
                if (!QS->decode_n_bytes(ctx, rl, quals)) {
                    g_error = "cram: quality decode failed";
                    return false;
                }
            } else {
                quals.assign(rl, (char)0xFF);
            }
        } else {
            // unmapped: bases stored verbatim
            NEED(BA, "BA");
            if (!BA->decode_n_bytes(ctx, rl, seq)) return false;
            if (cf & 0x1) {
                NEED(QS, "QS");
                if (!QS->decode_n_bytes(ctx, rl, quals)) return false;
            } else {
                quals.assign(rl, (char)0xFF);
            }
            mapq = 0;
        }
        if (!ok) {
            g_error = "cram: record field decode failed";
            return false;
        }

        // restore mate flags stripped into MF (detached records)
        int32_t flag = bf;
        if (detached) {
            if (mf & 0x1) flag |= 0x20;  // mate reverse strand
            if (mf & 0x2) flag |= 0x8;   // mate unmapped
        }

        bam->refid.push_back(ref_id);
        bam->pos.push_back(ap - 1);
        bam->mapq.push_back(mapq);
        bam->flag.push_back(flag);
        bam->lseq.push_back(rl);
        bam->ncigar.push_back((int32_t)cigar.size());
        bam->qname_blob.append(qname);
        bam->qname_off.push_back(bam->qname_blob.size());
        for (uint32_t cg : cigar) bam->cigar_blob.push_back(cg);
        bam->cigar_off.push_back(bam->cigar_blob.size());
        bam->seq_blob.append(seq);
        bam->seq_off.push_back(bam->seq_blob.size());
        bam->qual_blob.append(quals);
        bam->aux_blob.append(aux);
        bam->aux_off.push_back(bam->aux_blob.size());
    }
    return true;
}

void collect_rg_ids(const std::string& header_text, std::vector<std::string>& out) {
    size_t pos = 0;
    while (pos < header_text.size()) {
        size_t eol = header_text.find('\n', pos);
        if (eol == std::string::npos) eol = header_text.size();
        if (header_text.compare(pos, 3, "@RG") == 0) {
            size_t f = pos;
            while (f < eol) {
                size_t tab = header_text.find('\t', f);
                if (tab == std::string::npos || tab > eol) tab = eol;
                if (header_text.compare(f, 3, "ID:") == 0)
                    out.push_back(header_text.substr(f + 3, tab - f - 3));
                f = tab + 1;
            }
        }
        pos = eol + 1;
    }
}

void collect_sq(const std::string& header_text, BamData* bam) {
    size_t pos = 0;
    while (pos < header_text.size()) {
        size_t eol = header_text.find('\n', pos);
        if (eol == std::string::npos) eol = header_text.size();
        if (header_text.compare(pos, 3, "@SQ") == 0) {
            std::string name;
            int32_t len = 0;
            size_t f = pos;
            while (f < eol) {
                size_t tab = header_text.find('\t', f);
                if (tab == std::string::npos || tab > eol) tab = eol;
                if (header_text.compare(f, 3, "SN:") == 0)
                    name = header_text.substr(f + 3, tab - f - 3);
                else if (header_text.compare(f, 3, "LN:") == 0)
                    len = atoi(header_text.c_str() + f + 3);
                f = tab + 1;
            }
            bam->ref_names.push_back(name);
            bam->ref_lengths.push_back(len);
        }
        pos = eol + 1;
    }
}

}  // namespace

// Shared loader. With region_ref != nullptr only data containers whose
// (ref_id, start, span) header coordinates can overlap
// [rstart, rstop) of that reference decode — container headers are a
// few bytes, so skipping is O(1) per container and the expensive block
// decompression runs only for the region (the same information a .crai
// index stores per slice).  rstop == 0 with empty region_ref means
// "header only" (skip every data container).  Multi-reference
// containers (ref_id == -2) always decode; their records carry their
// own reference ids and are filtered by the caller.
static void* cram_load_impl(const char* path, const char* fasta_path,
                            const char* region_ref, int64_t rstart,
                            int64_t rstop) {
    g_error.clear();
    std::string data;
    {
        FILE* f = fopen(path, "rb");
        if (!f) {
            g_error = "cannot open file";
            return nullptr;
        }
        fseek(f, 0, SEEK_END);
        long size = ftell(f);
        fseek(f, 0, SEEK_SET);
        data.resize(size);
        if (fread(&data[0], 1, size, f) != (size_t)size) {
            fclose(f);
            g_error = "short read";
            return nullptr;
        }
        fclose(f);
    }
    if (data.size() < 26 || memcmp(data.data(), "CRAM", 4) != 0) {
        g_error = "not a CRAM file";
        return nullptr;
    }
    int major = (uint8_t)data[4];
    if (major != 3) {
        g_error = "cram: only CRAM major version 3 is supported";
        return nullptr;
    }

    std::map<std::string, std::string> fasta;
    bool have_fasta = false;
    if (fasta_path && fasta_path[0]) {
        if (!load_fasta(fasta_path, fasta)) return nullptr;
        have_fasta = true;
    }

    auto bam = std::make_unique<BamData>();
    bam->qname_off.push_back(0);
    bam->cigar_off.push_back(0);
    bam->seq_off.push_back(0);
    bam->aux_off.push_back(0);

    CramContext cx;
    cx.fasta = have_fasta ? &fasta : nullptr;
    cx.ref_names = &bam->ref_names;

    Cursor c{(const uint8_t*)data.data() + 26,
             (const uint8_t*)data.data() + data.size()};
    bool first = true;
    while (c.p < c.end) {
        ContainerHeader h;
        if (!read_container_header(c, h)) {
            g_error = "cram: bad container header";
            return nullptr;
        }
        const uint8_t* body = c.p;
        const uint8_t* body_end = body + h.length;
        if (body_end > c.end) {
            g_error = "cram: truncated container";
            return nullptr;
        }
        // EOF container: ref_id == -1 with no records and a tiny body
        if (h.ref_id == -1 && h.n_records == 0 && h.n_blocks <= 1 &&
            !first)
            break;
        Cursor cc{body, body_end};
        if (first) {
            // SAM header container: first block = int32 length + text
            Block b;
            if (!read_block(cc, b)) return nullptr;
            if (b.data.size() < 4) {
                g_error = "cram: bad SAM header block";
                return nullptr;
            }
            int32_t l_text;
            memcpy(&l_text, b.data.data(), 4);
            if (l_text < 0 || (size_t)l_text > b.data.size() - 4)
                l_text = (int32_t)b.data.size() - 4;
            bam->header_text.assign(b.data.data() + 4, l_text);
            while (!bam->header_text.empty() &&
                   (bam->header_text.back() == '\0'))
                bam->header_text.pop_back();
            collect_sq(bam->header_text, bam.get());
            collect_rg_ids(bam->header_text, cx.rg_ids);
            first = false;
            c.p = body_end;
            continue;
        }
        if (h.n_records == 0) {
            c.p = body_end;
            continue;
        }
        if (region_ref) {
            if (!region_ref[0] && rstop == 0) {
                // header-only load: skip every data container
                c.p = body_end;
                continue;
            }
            if (h.ref_id >= 0) {
                // resolve the region reference lazily (needs @SQ order)
                bool match = h.ref_id < (int32_t)bam->ref_names.size() &&
                             bam->ref_names[h.ref_id] == region_ref;
                int64_t c_start = (int64_t)h.start - 1;  // 1-based -> 0-based
                int64_t c_end = c_start + (int64_t)h.span;
                if (!match || c_end <= rstart || c_start >= rstop) {
                    c.p = body_end;
                    continue;
                }
            } else if (h.ref_id == -1) {
                c.p = body_end;  // unmapped container: outside any region
                continue;
            }
            // ref_id == -2 (multi-reference): decode, caller filters
        }
        // data container: block 0 = compression header, then slices at
        // the landmark offsets
        Block chb;
        if (!read_block(cc, chb)) return nullptr;
        if (chb.content_type != 1) {
            g_error = "cram: expected compression header block";
            return nullptr;
        }
        cx.comp = CompressionHeader();
        if (!parse_compression_header(chb.data, cx.comp)) {
            if (g_error.empty()) g_error = "cram: bad compression header";
            return nullptr;
        }
        for (size_t si = 0; si < h.landmarks.size(); si++) {
            Cursor sc{body + h.landmarks[si], body_end};
            Block shb;
            if (!read_block(sc, shb)) return nullptr;
            if (shb.content_type != 2) {
                g_error = "cram: expected slice header block";
                return nullptr;
            }
            SliceHeader sh;
            if (!parse_slice_header(shb.data, sh)) {
                g_error = "cram: bad slice header";
                return nullptr;
            }
            Block core_block;
            std::vector<std::unique_ptr<Block>> blocks;
            std::map<int, const Block*> ext;
            const std::string* embedded_ref = nullptr;
            for (int32_t bi = 0; bi < sh.n_blocks; bi++) {
                auto b = std::make_unique<Block>();
                if (!read_block(sc, *b)) return nullptr;
                if (b->content_type == 5) {
                    core_block = std::move(*b);
                } else if (b->content_type == 4) {
                    if (sh.embedded_ref_id >= 0 &&
                        b->content_id == sh.embedded_ref_id)
                        embedded_ref = &b->data;
                    ext[b->content_id] = b.get();
                    blocks.push_back(std::move(b));
                }
            }
            if (!decode_slice(bam.get(), cx, sh, core_block, ext,
                              embedded_ref)) {
                if (g_error.empty()) g_error = "cram: slice decode failed";
                return nullptr;
            }
        }
        c.p = body_end;
    }
    return bam.release();
}

extern "C" {

void* cram_load(const char* path, const char* fasta_path) {
    return cram_load_impl(path, fasta_path, nullptr, 0, 0);
}

// Region-limited load (htslib .crai fetch semantics without the index:
// CRAM container headers already carry the per-container coordinates).
// ref == "" with stop == 0 loads the SAM header only.
void* cram_load_region(const char* path, const char* fasta_path,
                       const char* ref, int64_t start, int64_t stop) {
    return cram_load_impl(path, fasta_path, ref ? ref : "", start, stop);
}

}  // extern "C"

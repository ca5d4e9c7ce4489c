// Native BAM/BGZF decoder: the host-side IO fast path.
//
// The reference delegates alignment decoding to htslib (via pysam); this
// framework ships its own native decoder so the host input pipeline can
// keep TPU device batches fed without a pysam dependency.  BGZF blocks
// are located via the BC extra field and inflated with zlib's raw
// inflate; records are parsed into columnar arrays that the Python layer
// wraps zero-copy via ctypes/numpy.
//
// C API (all exported with C linkage for ctypes):
//   bam_load(path)            -> handle (nullptr on failure; see bam_error)
//   bam_n_records/bam_header_text/... -> columnar accessors
//   bam_free(handle)
//
// Layout per record i (0-based):
//   refid[i], pos[i], mapq[i], flag[i], lseq[i], ncigar[i]
//   qname: bytes in [qname_off[i], qname_off[i+1]) of qname_blob (no NUL)
//   cigar: uint32 ops in [cigar_off[i], cigar_off[i+1]) of cigar_blob
//   seq:   ASCII bases in [seq_off[i], seq_off[i+1]) of seq_blob
//   qual:  phred bytes in [seq_off[i], seq_off[i+1]) of qual_blob
//   aux:   raw BAM aux bytes in [aux_off[i], aux_off[i+1]) of aux_blob

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "records.h"

thread_local std::string g_bam_error;

namespace {

std::string& g_error = g_bam_error;

const char SEQ_CODES[17] = "=ACMGRSVTWYHKDBN";

// Decompress an entire BGZF file into `out`.  Returns false on error.
bool inflate_bgzf(const char* path, std::string& out) {
    FILE* f = fopen(path, "rb");
    if (!f) {
        g_error = "cannot open file";
        return false;
    }
    std::vector<uint8_t> comp;
    {
        fseek(f, 0, SEEK_END);
        long size = ftell(f);
        fseek(f, 0, SEEK_SET);
        comp.resize(size);
        if (fread(comp.data(), 1, size, f) != (size_t)size) {
            fclose(f);
            g_error = "short read";
            return false;
        }
    }
    fclose(f);

    size_t off = 0;
    std::vector<uint8_t> buf(1 << 16);
    while (off + 18 <= comp.size()) {
        // gzip member header with BGZF "BC" extra field
        if (comp[off] != 0x1f || comp[off + 1] != 0x8b) {
            g_error = "bad gzip magic in BGZF stream";
            return false;
        }
        uint16_t xlen = comp[off + 10] | (comp[off + 11] << 8);
        size_t extra = off + 12;
        size_t bsize = 0;
        size_t xend = extra + xlen;
        while (extra + 4 <= xend) {
            uint8_t si1 = comp[extra], si2 = comp[extra + 1];
            uint16_t slen = comp[extra + 2] | (comp[extra + 3] << 8);
            if (si1 == 'B' && si2 == 'C' && slen == 2) {
                bsize = (comp[extra + 4] | (comp[extra + 5] << 8)) + 1;
            }
            extra += 4 + slen;
        }
        if (bsize == 0) {
            g_error = "missing BGZF BC field";
            return false;
        }
        size_t data_start = off + 12 + xlen;
        size_t data_len = bsize - (12 + xlen) - 8;  // minus CRC32+ISIZE
        uint32_t isize = comp[off + bsize - 4] | (comp[off + bsize - 3] << 8) |
                         (comp[off + bsize - 2] << 16) |
                         ((uint32_t)comp[off + bsize - 1] << 24);
        if (isize > 0) {
            if (buf.size() < isize) buf.resize(isize);
            z_stream zs;
            memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, -15) != Z_OK) {
                g_error = "inflateInit2 failed";
                return false;
            }
            zs.next_in = comp.data() + data_start;
            zs.avail_in = (uInt)data_len;
            zs.next_out = buf.data();
            zs.avail_out = isize;
            int ret = inflate(&zs, Z_FINISH);
            inflateEnd(&zs);
            if (ret != Z_STREAM_END) {
                g_error = "inflate failed";
                return false;
            }
            out.append((char*)buf.data(), isize);
        }
        off += bsize;
    }
    return true;
}

template <typename T>
T read_le(const std::string& s, size_t off) {
    T v;
    memcpy(&v, s.data() + off, sizeof(T));
    return v;
}

}  // namespace

extern "C" {

const char* bam_error() { return g_error.c_str(); }

void* bam_load(const char* path) {
    g_error.clear();
    std::string data;
    if (!inflate_bgzf(path, data)) return nullptr;
    if (data.size() < 12 || memcmp(data.data(), "BAM\1", 4) != 0) {
        g_error = "not a BAM stream";
        return nullptr;
    }
    BamData* bam = new BamData();
    size_t p = 4;
    int32_t l_text = read_le<int32_t>(data, p);
    p += 4;
    bam->header_text.assign(data.data() + p, l_text);
    // trim trailing NULs
    while (!bam->header_text.empty() && bam->header_text.back() == '\0')
        bam->header_text.pop_back();
    p += l_text;
    int32_t n_ref = read_le<int32_t>(data, p);
    p += 4;
    for (int32_t i = 0; i < n_ref; i++) {
        int32_t l_name = read_le<int32_t>(data, p);
        p += 4;
        bam->ref_names.emplace_back(data.data() + p, l_name - 1);
        p += l_name;
        bam->ref_lengths.push_back(read_le<int32_t>(data, p));
        p += 4;
    }
    for (auto& n : bam->ref_names) {
        bam->ref_name_blob += n;
        bam->ref_name_blob += '\n';
    }
    bam->qname_off.push_back(0);
    bam->cigar_off.push_back(0);
    bam->seq_off.push_back(0);
    bam->aux_off.push_back(0);
    while (p + 4 <= data.size()) {
        uint32_t block_size = read_le<uint32_t>(data, p);
        size_t base = p + 4;
        size_t end = base + block_size;
        if (end > data.size()) {
            g_error = "truncated record";
            delete bam;
            return nullptr;
        }
        bam->refid.push_back(read_le<int32_t>(data, base));
        bam->pos.push_back(read_le<int32_t>(data, base + 4));
        uint8_t l_read_name = (uint8_t)data[base + 8];
        bam->mapq.push_back((uint8_t)data[base + 9]);
        uint16_t n_cigar = read_le<uint16_t>(data, base + 12);
        uint16_t flag = read_le<uint16_t>(data, base + 14);
        int32_t l_seq = read_le<int32_t>(data, base + 16);
        bam->flag.push_back(flag);
        bam->lseq.push_back(l_seq);
        bam->ncigar.push_back(n_cigar);
        size_t q = base + 32;
        bam->qname_blob.append(data.data() + q, l_read_name - 1);
        bam->qname_off.push_back(bam->qname_blob.size());
        q += l_read_name;
        for (uint16_t i = 0; i < n_cigar; i++) {
            bam->cigar_blob.push_back(read_le<uint32_t>(data, q));
            q += 4;
        }
        bam->cigar_off.push_back(bam->cigar_blob.size());
        size_t nbytes = (l_seq + 1) / 2;
        for (int32_t i = 0; i < l_seq; i++) {
            uint8_t b = (uint8_t)data[q + i / 2];
            bam->seq_blob.push_back(
                SEQ_CODES[(i % 2 == 0) ? (b >> 4) : (b & 0xF)]);
        }
        q += nbytes;
        bam->seq_off.push_back(bam->seq_blob.size());
        bam->qual_blob.append(data.data() + q, l_seq);
        q += l_seq;
        bam->aux_blob.append(data.data() + q, end - q);
        bam->aux_off.push_back(bam->aux_blob.size());
        p = end;
    }
    return bam;
}

void bam_free(void* h) { delete (BamData*)h; }

int64_t bam_n_records(void* h) { return ((BamData*)h)->refid.size(); }
int64_t bam_n_refs(void* h) { return ((BamData*)h)->ref_names.size(); }
const char* bam_header_text(void* h) { return ((BamData*)h)->header_text.c_str(); }
const char* bam_ref_names(void* h) { return ((BamData*)h)->ref_name_blob.c_str(); }
const int32_t* bam_ref_lengths(void* h) { return ((BamData*)h)->ref_lengths.data(); }

const int32_t* bam_refid(void* h) { return ((BamData*)h)->refid.data(); }
const int32_t* bam_pos(void* h) { return ((BamData*)h)->pos.data(); }
const int32_t* bam_mapq(void* h) { return ((BamData*)h)->mapq.data(); }
const int32_t* bam_flag(void* h) { return ((BamData*)h)->flag.data(); }
const int32_t* bam_lseq(void* h) { return ((BamData*)h)->lseq.data(); }
const int32_t* bam_ncigar(void* h) { return ((BamData*)h)->ncigar.data(); }
const int64_t* bam_qname_off(void* h) { return ((BamData*)h)->qname_off.data(); }
const int64_t* bam_cigar_off(void* h) { return ((BamData*)h)->cigar_off.data(); }
const int64_t* bam_seq_off(void* h) { return ((BamData*)h)->seq_off.data(); }
const int64_t* bam_aux_off(void* h) { return ((BamData*)h)->aux_off.data(); }
const char* bam_qname_blob(void* h) { return ((BamData*)h)->qname_blob.data(); }
const uint32_t* bam_cigar_blob(void* h) { return ((BamData*)h)->cigar_blob.data(); }
const char* bam_seq_blob(void* h) { return ((BamData*)h)->seq_blob.data(); }
const char* bam_qual_blob(void* h) { return ((BamData*)h)->qual_blob.data(); }
const char* bam_aux_blob(void* h) { return ((BamData*)h)->aux_blob.data(); }

}  // extern "C"

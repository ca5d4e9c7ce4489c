// Columnar alignment-record container shared by the BAM and CRAM
// decoders.  The Python layer (io/bamlite.py) wraps these arrays
// zero-copy via ctypes/numpy; both loaders expose the same accessors.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

struct BamData {
    std::string header_text;
    std::vector<std::string> ref_names;
    std::vector<int32_t> ref_lengths;
    // columnar record data
    std::vector<int32_t> refid, pos;
    std::vector<int32_t> mapq, flag, lseq, ncigar;
    std::vector<int64_t> qname_off, cigar_off, seq_off, aux_off;
    std::string qname_blob;
    std::vector<uint32_t> cigar_blob;
    std::string seq_blob;
    std::string qual_blob;
    std::string aux_blob;
    std::string ref_name_blob;  // newline separated, for the accessor
};

extern thread_local std::string g_bam_error;

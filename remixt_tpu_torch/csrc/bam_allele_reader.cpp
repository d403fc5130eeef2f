// Native BAM allele reader of the PyTorch/CUDA port: below this header, a
// copy of the JAX package's src/bam_allele_reader.cpp, held to it character
// for character by tests/test_torch_copies.py.
//
// Streams one chromosome of a coordinate-sorted indexed BAM, pairs mates
// into concordant fragments, and classifies reads covering known SNP
// positions as ref/alt: discordant-pair and soft-clip filters, mate pairing
// via name buffers with a bounded queue, fragment records (id, start, end,
// min mapq, is duplicate), and per-read SNP base classification emitting
// (fragment id, 1-based position, is alt). BGZF block inflation via zlib,
// BAM record parsing and the BAI linear-index seek are self-contained.
// Exposed through a plain C API consumed by ctypes
// (remixt_tpu_torch/io/bamreader.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

class BgzfReader {
public:
    explicit BgzfReader(const std::string& path) : file_(fopen(path.c_str(), "rb")) {
        if (!file_) throw std::runtime_error("unable to open " + path);
    }

    ~BgzfReader() {
        if (file_) fclose(file_);
    }

    // seek to a BGZF virtual offset (coffset << 16 | uoffset)
    void SeekVirtual(uint64_t voffset) {
        uint64_t coffset = voffset >> 16;
        uint16_t uoffset = voffset & 0xffff;
        if (fseek(file_, (long)coffset, SEEK_SET) != 0)
            throw std::runtime_error("bgzf seek failed");
        block_.clear();
        block_pos_ = 0;
        eof_ = false;
        if (!ReadBlock()) return;
        block_pos_ = uoffset;
    }

    // read exactly n bytes; false on clean EOF at a block boundary
    bool Read(void* dst, size_t n) {
        uint8_t* out = static_cast<uint8_t*>(dst);
        size_t got = 0;
        while (got < n) {
            if (block_pos_ >= block_.size()) {
                if (!ReadBlock()) {
                    if (got == 0) return false;
                    throw std::runtime_error("truncated bgzf stream");
                }
                continue;
            }
            size_t take = std::min(n - got, block_.size() - block_pos_);
            memcpy(out + got, block_.data() + block_pos_, take);
            block_pos_ += take;
            got += take;
        }
        return true;
    }

    bool Eof() const { return eof_ && block_pos_ >= block_.size(); }

private:
    bool ReadBlock() {
        if (eof_) return false;
        uint8_t header[18];
        size_t n = fread(header, 1, sizeof(header), file_);
        if (n == 0) { eof_ = true; return false; }
        if (n < sizeof(header)) throw std::runtime_error("truncated bgzf header");
        if (header[0] != 0x1f || header[1] != 0x8b)
            throw std::runtime_error("not a bgzf/gzip stream");

        // locate BSIZE in the extra field (SI1=66, SI2=67)
        uint16_t xlen = header[10] | (header[11] << 8);
        std::vector<uint8_t> extra(xlen);
        // bytes 12..17 already consumed from the extra field
        memcpy(extra.data(), header + 12, std::min<size_t>(6, xlen));
        if (xlen > 6) {
            if (fread(extra.data() + 6, 1, xlen - 6, file_) != (size_t)(xlen - 6))
                throw std::runtime_error("truncated bgzf extra field");
        }

        int bsize = -1;
        for (size_t i = 0; i + 4 <= extra.size();) {
            uint8_t si1 = extra[i], si2 = extra[i + 1];
            uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
            if (si1 == 66 && si2 == 67 && slen == 2)
                bsize = extra[i + 4] | (extra[i + 5] << 8);
            i += 4 + slen;
        }
        if (bsize < 0) throw std::runtime_error("missing bgzf BSIZE");

        size_t cdata_len = bsize + 1 - 12 - xlen - 8;
        std::vector<uint8_t> cdata(cdata_len);
        if (fread(cdata.data(), 1, cdata_len, file_) != cdata_len)
            throw std::runtime_error("truncated bgzf block");

        uint8_t footer[8];
        if (fread(footer, 1, 8, file_) != 8)
            throw std::runtime_error("truncated bgzf footer");
        uint32_t isize = footer[4] | (footer[5] << 8) | (footer[6] << 16)
            | ((uint32_t)footer[7] << 24);

        block_.resize(isize);
        block_pos_ = 0;
        if (isize == 0) {
            // EOF marker block
            return ReadBlock();
        }

        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK)
            throw std::runtime_error("inflateInit2 failed");
        zs.next_in = cdata.data();
        zs.avail_in = (uInt)cdata_len;
        zs.next_out = block_.data();
        zs.avail_out = isize;
        int ret = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        if (ret != Z_STREAM_END)
            throw std::runtime_error("bgzf inflate failed");
        return true;
    }

    FILE* file_;
    std::vector<uint8_t> block_;
    size_t block_pos_ = 0;
    bool eof_ = false;
};

// ---------------------------------------------------------------------------
// BAM records
// ---------------------------------------------------------------------------

struct BamRecord {
    int32_t ref_id = -1;
    int32_t pos = -1;
    uint16_t flag = 0;
    uint8_t mapq = 0;
    int32_t tlen = 0;
    std::string name;
    std::vector<uint32_t> cigar;
    std::string seq;  // decoded bases

    bool IsPaired() const { return flag & 0x1; }
    bool IsProperPair() const { return flag & 0x2; }
    bool IsMapped() const { return !(flag & 0x4); }
    bool IsFailedQC() const { return flag & 0x200; }
    bool IsDuplicate() const { return flag & 0x400; }
    bool IsPrimary() const { return !(flag & 0x100); }
    bool IsFirstMate() const { return flag & 0x40; }

    int NumSoftClipped() const {
        int total = 0;
        for (uint32_t op : cigar)
            if ((op & 0xf) == 4) total += op >> 4;  // 'S'
        return total;
    }

    // aligned span end on the reference (pos-based, exclusive)
    int32_t RefEnd() const {
        int32_t end = pos;
        for (uint32_t op : cigar) {
            int kind = op & 0xf;
            int len = op >> 4;
            // M, D, N, =, X consume reference
            if (kind == 0 || kind == 2 || kind == 3 || kind == 7 || kind == 8)
                end += len;
        }
        return end;
    }

    // query offset aligned to reference position p, or -1 when p falls in a
    // deletion/skip or outside the alignment
    int QueryPosition(int32_t p) const {
        int32_t ref = pos;
        int32_t query = 0;
        for (uint32_t op : cigar) {
            int kind = op & 0xf;
            int len = op >> 4;
            switch (kind) {
                case 0: case 7: case 8:  // M, =, X
                    if (p < ref + len && p >= ref) return query + (p - ref);
                    ref += len; query += len;
                    break;
                case 1: case 4:          // I, S consume query only
                    query += len;
                    break;
                case 2: case 3:          // D, N consume reference only
                    if (p < ref + len && p >= ref) return -1;
                    ref += len;
                    break;
                default:
                    break;               // H, P consume neither
            }
        }
        return -1;
    }
};

const char kSeqCode[17] = "=ACMGRSVTWYHKDBN";

class BamFile {
public:
    explicit BamFile(const std::string& path) : bgzf_(path) {
        char magic[4];
        if (!bgzf_.Read(magic, 4) || memcmp(magic, "BAM\1", 4) != 0)
            throw std::runtime_error("not a BAM file: " + path);
        int32_t l_text;
        ReadInt(l_text);
        std::vector<char> text(l_text);
        if (l_text) bgzf_.Read(text.data(), l_text);
        int32_t n_ref;
        ReadInt(n_ref);
        for (int32_t i = 0; i < n_ref; i++) {
            int32_t l_name;
            ReadInt(l_name);
            std::vector<char> name(l_name);
            bgzf_.Read(name.data(), l_name);
            int32_t l_ref;
            ReadInt(l_ref);
            ref_names_.emplace_back(name.data());
        }
    }

    int RefId(const std::string& name) const {
        for (size_t i = 0; i < ref_names_.size(); i++)
            if (ref_names_[i] == name) return (int)i;
        return -1;
    }

    void SeekVirtual(uint64_t voffset) { bgzf_.SeekVirtual(voffset); }

    bool Next(BamRecord& rec) {
        int32_t block_size;
        if (!bgzf_.Read(&block_size, 4)) return false;
        std::vector<uint8_t> data(block_size);
        if (!bgzf_.Read(data.data(), block_size))
            throw std::runtime_error("truncated BAM record");

        const uint8_t* p = data.data();
        auto rd_i32 = [&p]() { int32_t v; memcpy(&v, p, 4); p += 4; return v; };

        rec.ref_id = rd_i32();
        rec.pos = rd_i32();
        uint8_t l_read_name = *p++;
        rec.mapq = *p++;
        p += 2;  // bin
        uint16_t n_cigar_op; memcpy(&n_cigar_op, p, 2); p += 2;
        memcpy(&rec.flag, p, 2); p += 2;
        int32_t l_seq = rd_i32();
        rd_i32();  // next_ref_id
        rd_i32();  // next_pos
        rec.tlen = rd_i32();

        rec.name.assign(reinterpret_cast<const char*>(p), l_read_name - 1);
        p += l_read_name;

        rec.cigar.assign(n_cigar_op, 0);
        memcpy(rec.cigar.data(), p, 4 * (size_t)n_cigar_op);
        p += 4 * (size_t)n_cigar_op;

        rec.seq.resize(l_seq);
        for (int32_t i = 0; i < l_seq; i++) {
            uint8_t code = (p[i / 2] >> ((i % 2) ? 0 : 4)) & 0xf;
            rec.seq[i] = kSeqCode[code];
        }
        return true;
    }

private:
    void ReadInt(int32_t& v) {
        if (!bgzf_.Read(&v, 4)) throw std::runtime_error("truncated BAM header");
    }

    BgzfReader bgzf_;
    std::vector<std::string> ref_names_;
};

// first virtual offset covering a reference in the BAI linear index
uint64_t BaiRefOffset(const std::string& bai_path, int ref_id, bool* found) {
    FILE* f = fopen(bai_path.c_str(), "rb");
    if (!f) throw std::runtime_error("unable to open index " + bai_path);

    auto rd_u32 = [f]() {
        uint32_t v;
        if (fread(&v, 4, 1, f) != 1) throw std::runtime_error("truncated BAI");
        return v;
    };
    auto rd_u64 = [f]() {
        uint64_t v;
        if (fread(&v, 8, 1, f) != 1) throw std::runtime_error("truncated BAI");
        return v;
    };

    char magic[4];
    if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "BAI\1", 4) != 0) {
        fclose(f);
        throw std::runtime_error("not a BAI index: " + bai_path);
    }

    uint32_t n_ref = rd_u32();
    uint64_t result = 0;
    *found = false;

    for (uint32_t r = 0; r < n_ref; r++) {
        uint64_t min_chunk_beg = UINT64_MAX;
        uint32_t n_bin = rd_u32();
        for (uint32_t b = 0; b < n_bin; b++) {
            uint32_t bin = rd_u32();
            uint32_t n_chunk = rd_u32();
            for (uint32_t c = 0; c < n_chunk; c++) {
                uint64_t beg = rd_u64();
                rd_u64();  // chunk end
                if (bin != 37450 && beg < min_chunk_beg) min_chunk_beg = beg;
            }
        }
        uint32_t n_intv = rd_u32();
        for (uint32_t i = 0; i < n_intv; i++) {
            uint64_t ioffset = rd_u64();
            if (ioffset != 0 && ioffset < min_chunk_beg) min_chunk_beg = ioffset;
        }
        if ((int)r == ref_id && min_chunk_beg != UINT64_MAX) {
            result = min_chunk_beg;
            *found = true;
        }
    }

    fclose(f);
    return result;
}

// ---------------------------------------------------------------------------
// allele reader
// ---------------------------------------------------------------------------

struct SNPInfo {
    int32_t position;  // 0-based
    char ref;
    char alt;
    bool operator<(const SNPInfo& o) const { return position < o.position; }
};

struct FragmentData {
    int32_t fragment_id, start, end, mapping_quality, is_duplicate;
};

struct AlleleData {
    int32_t fragment_id, position, is_alt;
};

bool IsReadPairDiscordant(const BamRecord& rec, int max_fragment_length,
                          bool check_proper_pair) {
    return !((rec.IsProperPair() || !check_proper_pair) &&
             rec.tlen != 0 &&
             std::abs(rec.tlen) <= max_fragment_length);
}

bool IsReadValidConcordant(const BamRecord& rec, int max_soft_clipped) {
    return rec.NumSoftClipped() <= max_soft_clipped &&
           rec.IsMapped() &&
           !rec.IsFailedQC();
}

class AlleleReader {
public:
    AlleleReader(const std::string& bam_path, const std::string& snp_path,
                 const std::string& chromosome, int max_fragment_length,
                 int max_soft_clipped, bool check_proper_pair)
        : bam_(bam_path),
          max_fragment_length_(max_fragment_length),
          max_soft_clipped_(max_soft_clipped),
          check_proper_pair_(check_proper_pair) {
        ref_id_ = bam_.RefId(chromosome);
        if (ref_id_ < 0)
            throw std::runtime_error("unable to find chromosome " + chromosome);

        bool found = false;
        uint64_t voffset = BaiRefOffset(bam_path + ".bai", ref_id_, &found);
        if (found) {
            bam_.SeekVirtual(voffset);
        }
        has_data_ = found;

        if (!snp_path.empty()) ReadSNPs(snp_path, chromosome);
        snp_begin_ = 0;
    }

    void ReadSNPs(const std::string& snp_path, const std::string& chromosome) {
        FILE* f = fopen(snp_path.c_str(), "r");
        if (!f) throw std::runtime_error("unable to open " + snp_path);
        char chrom[256], ref[256], alt[256];
        long position;
        while (fscanf(f, "%255s %ld %255s %255s", chrom, &position, ref, alt) == 4) {
            if (chromosome != chrom) continue;
            if (strlen(ref) != 1 || strlen(alt) != 1) {
                fclose(f);
                throw std::runtime_error("expected single nucleotide alleles");
            }
            // convert to 0-based
            snps_.push_back(SNPInfo{(int32_t)(position - 1), ref[0], alt[0]});
        }
        fclose(f);
        std::sort(snps_.begin(), snps_.end());
    }

    bool ReadAlignments(int max_alignments) {
        fragments_.clear();
        alleles_.clear();

        if (!has_data_ || finished_) return false;

        bool finished = false;
        BamRecord rec;
        for (int idx = 0; idx < max_alignments; idx++) {
            if (!bam_.Next(rec)) { finished = true; break; }
            if (rec.ref_id != ref_id_) { finished = true; break; }
            if (!rec.IsPrimary()) continue;
            if (IsReadPairDiscordant(rec, max_fragment_length_, check_proper_pair_))
                continue;

            bool valid = IsReadValidConcordant(rec, max_soft_clipped_);
            if (valid) read_queue_.push_back(rec);

            int end = rec.IsFirstMate() ? 0 : 1;
            int other = 1 - end;

            auto other_iter = read_buffer_[other].find(rec.name);
            if (other_iter != read_buffer_[other].end()) {
                BamRecord& mate = other_iter->second;
                bool valid_mate = IsReadValidConcordant(mate, max_soft_clipped_);
                bool valid_pair = valid && valid_mate;

                if (valid_pair) {
                    int32_t fragment_start = std::min(rec.pos, mate.pos);
                    int32_t fragment_end = fragment_start + std::abs(rec.tlen);
                    int32_t is_duplicate = rec.IsDuplicate() || mate.IsDuplicate();
                    int32_t mapping_quality = std::min(rec.mapq, mate.mapq);

                    int32_t fragment_id = next_fragment_id_++;
                    fragment_id_[0][rec.name] = fragment_id;
                    fragment_id_[1][rec.name] = fragment_id;

                    fragments_.push_back(FragmentData{
                        fragment_id, fragment_start, fragment_end,
                        mapping_quality, is_duplicate});
                }

                if (valid)
                    read_status_[end][rec.name] = valid_pair;
                if (valid_mate)
                    read_status_[1 - end][mate.name] = valid_pair;

                read_buffer_[other].erase(other_iter);
            } else {
                read_buffer_[end][rec.name] = rec;
            }

            DrainQueue(rec.pos, false);
        }

        if (finished) {
            DrainQueue(0, true);
            finished_ = true;
        }

        // true while the stream may still produce data: the final batch
        // (with flushed pairs) returns true, the next call returns false.
        // (The reference returns false on any empty batch —
        // BamAlleleReader.cpp:327 — which silently truncates with small
        // batch sizes; kept as a fix, compatible with the streaming loop in
        // seqdataio.)
        return !finished_ || !fragments_.empty() || !alleles_.empty();
    }

    const std::vector<FragmentData>& fragments() const { return fragments_; }
    const std::vector<AlleleData>& alleles() const { return alleles_; }

private:
    void DrainQueue(int32_t current_pos, bool flush) {
        while (!read_queue_.empty()) {
            BamRecord& next = read_queue_.front();
            int end = next.IsFirstMate() ? 0 : 1;

            auto status_iter = read_status_[end].find(next.name);
            if (status_iter != read_status_[end].end()) {
                if (status_iter->second) ClassifySNPs(next);
                read_status_[end].erase(status_iter);
                // retire the fragment id (the reference's discard visitor,
                // BamAlleleReader.cpp:385-388); each per-end entry is
                // consumed exactly once
                fragment_id_[end].erase(next.name);
            } else if (flush || current_pos - next.pos > 2 * max_fragment_length_) {
                fprintf(stderr, "Warning: Could not match read %s\n",
                        next.name.c_str());
            } else {
                break;
            }
            read_queue_.pop_front();
        }
    }

    void ClassifySNPs(const BamRecord& rec) {
        if (snps_.empty()) return;
        int32_t ref_end = rec.RefEnd();

        // advance the global SNP cursor (reads arrive position-sorted)
        while (snp_begin_ < snps_.size()
               && snps_[snp_begin_].position < rec.pos - 2 * max_fragment_length_)
            snp_begin_++;

        int end = rec.IsFirstMate() ? 0 : 1;
        auto id_iter = fragment_id_[end].find(rec.name);
        if (id_iter == fragment_id_[end].end()) return;
        int32_t fragment_id = id_iter->second;

        for (size_t i = snp_begin_; i < snps_.size(); i++) {
            const SNPInfo& snp = snps_[i];
            if (snp.position >= ref_end) break;
            if (snp.position < rec.pos) continue;

            int qpos = rec.QueryPosition(snp.position);
            if (qpos < 0 || qpos >= (int)rec.seq.size()) continue;

            char base = toupper(rec.seq[qpos]);
            int is_alt;
            if (base == snp.alt) is_alt = 1;
            else if (base == snp.ref) is_alt = 0;
            else continue;

            // 1-based output positions
            alleles_.push_back(AlleleData{fragment_id, snp.position + 1, is_alt});
        }
    }

    BamFile bam_;
    int ref_id_;
    bool has_data_;
    bool finished_ = false;
    int max_fragment_length_;
    int max_soft_clipped_;
    bool check_proper_pair_;

    std::deque<BamRecord> read_queue_;
    std::map<std::string, BamRecord> read_buffer_[2];
    std::map<std::string, bool> read_status_[2];
    std::map<std::string, int32_t> fragment_id_[2];
    int32_t next_fragment_id_ = 0;

    std::vector<SNPInfo> snps_;
    size_t snp_begin_ = 0;

    std::vector<FragmentData> fragments_;
    std::vector<AlleleData> alleles_;
};

thread_local std::string g_last_error;

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

void* allele_reader_create(const char* bam_path, const char* snp_path,
                           const char* chromosome, int max_fragment_length,
                           int max_soft_clipped, int check_proper_pair) {
    try {
        return new AlleleReader(bam_path, snp_path ? snp_path : "", chromosome,
                                max_fragment_length, max_soft_clipped,
                                check_proper_pair != 0);
    } catch (const std::exception& e) {
        g_last_error = e.what();
        return nullptr;
    }
}

void allele_reader_destroy(void* reader) {
    delete static_cast<AlleleReader*>(reader);
}

int allele_reader_read_alignments(void* reader, int max_alignments) {
    try {
        return static_cast<AlleleReader*>(reader)->ReadAlignments(max_alignments)
            ? 1 : 0;
    } catch (const std::exception& e) {
        g_last_error = e.what();
        return -1;
    }
}

long allele_reader_num_fragments(void* reader) {
    return (long)static_cast<AlleleReader*>(reader)->fragments().size();
}

long allele_reader_num_alleles(void* reader) {
    return (long)static_cast<AlleleReader*>(reader)->alleles().size();
}

// columns: fragment_id, start, end, mapping_quality, is_duplicate
void allele_reader_get_fragments(void* reader, int32_t* out) {
    const auto& fragments = static_cast<AlleleReader*>(reader)->fragments();
    for (size_t i = 0; i < fragments.size(); i++) {
        out[i * 5 + 0] = fragments[i].fragment_id;
        out[i * 5 + 1] = fragments[i].start;
        out[i * 5 + 2] = fragments[i].end;
        out[i * 5 + 3] = fragments[i].mapping_quality;
        out[i * 5 + 4] = fragments[i].is_duplicate;
    }
}

// columns: fragment_id, position, is_alt
void allele_reader_get_alleles(void* reader, int32_t* out) {
    const auto& alleles = static_cast<AlleleReader*>(reader)->alleles();
    for (size_t i = 0; i < alleles.size(); i++) {
        out[i * 3 + 0] = alleles[i].fragment_id;
        out[i * 3 + 1] = alleles[i].position;
        out[i * 3 + 2] = alleles[i].is_alt;
    }
}

const char* allele_reader_last_error() {
    return g_last_error.c_str();
}

}  // extern "C"

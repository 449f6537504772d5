// The caption tokenizer of the PyTorch port, in C++: the port's own copy of
// the tokenizer in the JAX package's native data-path library, so that the
// two packages give the same ids and draw caption drops from the same
// stream (a std::mt19937_64 seeded by the caller).
//
//   * vocab construction + lookup (string hash map)
//   * caption tokenization (lowercase, treebank-style splitting of
//     punctuation and n't/'s/'re/'ve/'ll/'d/'m contractions) straight
//     into padded int32 id matrices, including <start>/<end> wrapping
//     and the caption-drop augmentation (unk substitution + deletion,
//     reference load_datasets.py:277-295 semantics)
//
// It also holds the pixel work of the PNG and GIF readers
// (creamfl_tpu_torch/data/png_gif.py): PNG's unfiltering (None, Sub, Up,
// Average, Paeth), Adam7 de-interlacing and the expansion of every colour
// type and bit depth to RGB, and GIF's LZW decode of a frame with its
// palette, each as PIL's Image.open(...).convert("RGB") gives the pixels.
//
// Plain C interface for ctypes (creamfl_tpu_torch/data/native.py), which
// builds it with g++ at first use (ops/build.py GXX_FLAGS). Host code
// only: nothing here runs on the card.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <string>
#include <unordered_map>
#include <vector>
#include <random>

extern "C" {

// ---------------------------------------------------------------------
// Vocab
// ---------------------------------------------------------------------

struct Vocab {
    std::unordered_map<std::string, int32_t> map;
    int32_t unk = 3;
    int32_t start = 1;
    int32_t end = 2;
};

void* vocab_create(const char** words, const int32_t* ids, int n,
                   int32_t start_id, int32_t end_id, int32_t unk_id) {
    auto* v = new Vocab();
    v->map.reserve(n * 2);
    for (int i = 0; i < n; ++i) v->map.emplace(words[i], ids[i]);
    v->start = start_id;
    v->end = end_id;
    v->unk = unk_id;
    return v;
}

void vocab_free(void* handle) { delete static_cast<Vocab*>(handle); }

int32_t vocab_lookup(void* handle, const char* word) {
    auto* v = static_cast<Vocab*>(handle);
    auto it = v->map.find(word);
    return it == v->map.end() ? v->unk : it->second;
}

// ---------------------------------------------------------------------
// Tokenization
// ---------------------------------------------------------------------

// Faithful byte-level port of nltk 3.10 TreebankWordTokenizer.tokenize
// (the reference tokenizes captions with nltk word_tokenize =
// punkt sentence split + Treebank; COCO/F30k captions are single
// sentences, so Treebank alone is the oracle —
// src/utils/load_datasets.py:277-295). Each pass below replicates one
// of nltk's regex substitutions with re.sub semantics: sequential
// left-to-right scan, non-overlapping matches, resume after each
// match. Input is already lowercased (tokenize_batch), so the
// case-insensitive alternations collapse. Verified against nltk on a
// 12k-caption adversarial fuzz corpus (tests/test_native_fuzz.py).

static bool is_digit_c(char c) { return c >= '0' && c <= '9'; }

static bool in_set(char c, const char* set) {
    return c != '\0' && std::strchr(set, c) != nullptr;
}

static bool is_space_c(char c) {
    return std::isspace((unsigned char)c) != 0;
}

// STARTING_QUOTES 1: ^" -> ``
static std::string p_caret_quote(const std::string& s) {
    if (!s.empty() && s[0] == '"') return "``" + s.substr(1);
    return s;
}

// STARTING_QUOTES 2: (``) -> ' \1 '
static std::string p_wrap_backticks(const std::string& s) {
    std::string o;
    size_t i = 0;
    while (i < s.size()) {
        if (s[i] == '`' && i + 1 < s.size() && s[i + 1] == '`') {
            o += " `` ";
            i += 2;
        } else {
            o += s[i++];
        }
    }
    return o;
}

// STARTING_QUOTES 3: ([ ([{<])("|'') -> '\1 `` '
static std::string p_open_quote(const std::string& s) {
    std::string o;
    size_t i = 0;
    while (i < s.size()) {
        char c = s[i];
        if (in_set(c, " ([{<") && i + 1 < s.size()) {
            if (s[i + 1] == '"') {
                o += c;
                o += " `` ";
                i += 2;
                continue;
            }
            if (s[i + 1] == '\'' && i + 2 < s.size()
                && s[i + 2] == '\'') {
                o += c;
                o += " `` ";
                i += 3;
                continue;
            }
        }
        o += c;
        ++i;
    }
    return o;
}

// PUNCTUATION 1: ([:,])([^\d]) -> ' \1 \2'
static std::string p_colon_comma(const std::string& s) {
    std::string o;
    size_t i = 0;
    while (i < s.size()) {
        char c = s[i];
        if ((c == ':' || c == ',') && i + 1 < s.size()
            && !is_digit_c(s[i + 1])) {
            o += ' ';
            o += c;
            o += ' ';
            o += s[i + 1];
            i += 2;
        } else {
            o += s[i++];
        }
    }
    return o;
}

// PUNCTUATION 2: ([:,])$ -> ' \1 '
static std::string p_colon_comma_end(const std::string& s) {
    if (!s.empty() && (s.back() == ':' || s.back() == ',')) {
        std::string o = s.substr(0, s.size() - 1);
        o += ' ';
        o += s.back();
        o += ' ';
        return o;
    }
    return s;
}

// PUNCTUATION 3: \.\.\. -> ' ... '
static std::string p_ellipsis(const std::string& s) {
    std::string o;
    size_t i = 0;
    while (i < s.size()) {
        if (s[i] == '.' && i + 2 < s.size() && s[i + 1] == '.'
            && s[i + 2] == '.') {
            o += " ... ";
            i += 3;
        } else {
            o += s[i++];
        }
    }
    return o;
}

// PUNCTUATION 4/6: single-char classes -> ' c '
static std::string p_space_class(const std::string& s, const char* cls) {
    std::string o;
    for (char c : s) {
        if (in_set(c, cls)) {
            o += ' ';
            o += c;
            o += ' ';
        } else {
            o += c;
        }
    }
    return o;
}

// PUNCTUATION 5: ([^\.])(\.)([])}>"']*)\s*$ -> '\1 \2\3 '
static std::string p_final_period(const std::string& s) {
    long j = (long)s.size() - 1;
    while (j >= 0 && is_space_c(s[j])) --j;
    long k = j;
    while (k >= 0 && in_set(s[k], "])}>\"'")) --k;
    if (k >= 1 && s[k] == '.' && s[k - 1] != '.') {
        return s.substr(0, k) + " " + s.substr(k, j - k + 1) + " ";
    }
    return s;
}

// PUNCTUATION 7: ([^'])' (space) -> "\1 ' "
static std::string p_apos_space(const std::string& s) {
    std::string o;
    size_t i = 0;
    while (i < s.size()) {
        if (s[i] != '\'' && i + 2 < s.size() && s[i + 1] == '\''
            && s[i + 2] == ' ') {
            o += s[i];
            o += " ' ";
            i += 3;
        } else {
            o += s[i++];
        }
    }
    return o;
}

// DOUBLE_DASHES: -- -> ' -- '
static std::string p_ddash(const std::string& s) {
    std::string o;
    size_t i = 0;
    while (i < s.size()) {
        if (s[i] == '-' && i + 1 < s.size() && s[i + 1] == '-') {
            o += " -- ";
            i += 2;
        } else {
            o += s[i++];
        }
    }
    return o;
}

// ENDING_QUOTES 1+2: '' -> " '' " then " -> " '' "
static std::string p_close_quotes(const std::string& s) {
    std::string o;
    size_t i = 0;
    while (i < s.size()) {
        if (s[i] == '\'' && i + 1 < s.size() && s[i + 1] == '\'') {
            o += " '' ";
            i += 2;
        } else {
            o += s[i++];
        }
    }
    std::string o2;
    for (char c : o) {
        if (c == '"') o2 += " '' ";
        else o2 += c;
    }
    return o2;
}

// ENDING_QUOTES 3: ([^' ])('s|'m|'d|') (space) -> '\1 \2 '
static std::string p_contr_short(const std::string& s) {
    std::string o;
    size_t i = 0, n = s.size();
    while (i < n) {
        char c = s[i];
        if (c != '\'' && c != ' ' && i + 1 < n && s[i + 1] == '\'') {
            size_t len = 0;  // suffix length incl. the apostrophe
            if (i + 3 < n && in_set(s[i + 2], "smd") && s[i + 3] == ' ')
                len = 2;
            else if (i + 2 < n && s[i + 2] == ' ')
                len = 1;
            if (len) {
                o += c;
                o += ' ';
                o += s.substr(i + 1, len);
                o += ' ';
                i += 1 + len + 1;  // \1 + suffix + trailing space
                continue;
            }
        }
        o += s[i++];
    }
    return o;
}

// ENDING_QUOTES 4: ([^' ])('ll|'re|'ve|n't) (space) -> '\1 \2 '
static std::string p_contr_long(const std::string& s) {
    std::string o;
    size_t i = 0, n = s.size();
    while (i < n) {
        char c = s[i];
        if (c != '\'' && c != ' ' && i + 4 < n) {
            if (s[i + 1] == '\''
                && ((s[i + 2] == 'l' && s[i + 3] == 'l')
                    || (s[i + 2] == 'r' && s[i + 3] == 'e')
                    || (s[i + 2] == 'v' && s[i + 3] == 'e'))
                && s[i + 4] == ' ') {
                o += c;
                o += ' ';
                o += s.substr(i + 1, 3);
                o += ' ';
                i += 5;
                continue;
            }
            if (s[i + 1] == 'n' && s[i + 2] == '\'' && s[i + 3] == 't'
                && s[i + 4] == ' ') {
                o += c;
                o += " n't ";
                i += 5;
                continue;
            }
        }
        o += s[i++];
    }
    return o;
}

// \b word characters (python re \w over utf-8 bytes: multibyte
// letters count as word chars).
static bool is_bword(unsigned char c) {
    return std::isalnum(c) != 0 || c == '_' || c >= 0x80;
}

// CONTRACTIONS2: \b(full)\b -> ' first second ' at a fixed split;
// `wanna` uses a (?=\s) lookahead instead of the trailing \b.
struct Contr2 {
    const char* full;
    int split;
    bool lookahead_space;
};

static const Contr2 CONTR2[] = {
    {"cannot", 3, false}, {"d'ye", 1, false},  {"gimme", 3, false},
    {"gonna", 3, false},  {"gotta", 3, false}, {"lemme", 3, false},
    {"more'n", 4, false}, {"wanna", 3, true},
};

static std::string p_contr2_one(const std::string& s, const Contr2& c) {
    const size_t flen = std::strlen(c.full);
    std::string o;
    size_t i = 0, n = s.size();
    while (i < n) {
        if (s.compare(i, flen, c.full) == 0
            && (i == 0 || !is_bword((unsigned char)s[i - 1]))) {
            bool ok;
            if (c.lookahead_space) {
                ok = i + flen < n && is_space_c(s[i + flen]);
            } else {
                ok = i + flen == n
                     || !is_bword((unsigned char)s[i + flen]);
            }
            if (ok) {
                o += ' ';
                o.append(c.full, c.split);
                o += ' ';
                o.append(c.full + c.split, flen - c.split);
                o += ' ';
                i += flen;  // lookahead is not consumed
                continue;
            }
        }
        o += s[i++];
    }
    return o;
}

// CONTRACTIONS3: " ('t)(is|was)\b" -> " 't is " / " 't was "
static std::string p_contr3_one(const std::string& s,
                                const char* tail) {
    const size_t tlen = std::strlen(tail);
    std::string o;
    size_t i = 0, n = s.size();
    while (i < n) {
        if (s[i] == ' ' && s.compare(i + 1, 2, "'t") == 0
            && s.compare(i + 3, tlen, tail) == 0
            && (i + 3 + tlen == n
                || !is_bword((unsigned char)s[i + 3 + tlen]))) {
            o += " 't ";
            o += tail;
            o += ' ';
            i += 3 + tlen;
            continue;
        }
        o += s[i++];
    }
    return o;
}

static void tokenize_one(const std::string& text,
                         std::vector<std::string>& out) {
    // nltk pipeline order (TreebankWordTokenizer.tokenize).
    std::string s = p_caret_quote(text);
    s = p_wrap_backticks(s);
    s = p_open_quote(s);

    s = p_colon_comma(s);
    s = p_colon_comma_end(s);
    s = p_ellipsis(s);
    s = p_space_class(s, ";@#$%&");
    s = p_final_period(s);
    s = p_space_class(s, "?!");
    s = p_apos_space(s);

    s = p_space_class(s, "][(){}<>");
    s = p_ddash(s);

    s = " " + s + " ";

    s = p_close_quotes(s);
    s = p_contr_short(s);
    s = p_contr_long(s);

    for (const Contr2& c : CONTR2) s = p_contr2_one(s, c);
    s = p_contr3_one(s, "is");
    s = p_contr3_one(s, "was");

    size_t i = 0;
    while (i < s.size()) {
        while (i < s.size() && is_space_c(s[i])) ++i;
        size_t j = i;
        while (j < s.size() && !is_space_c(s[j])) ++j;
        if (j > i) out.push_back(s.substr(i, j - i));
        i = j;
    }
}

// Tokenize a batch of captions into a padded [n, max_len] id matrix.
// caption_drop_prob > 0 applies the reference's double augmentation:
// unk substitution with prob p per token, then deletion of
// int(len * p) random tokens. Returns nothing; lengths written out.
void tokenize_batch(void* vocab_handle, const char** texts, int n,
                    int32_t max_len, float caption_drop_prob,
                    uint64_t seed, int32_t* out_ids,
                    int32_t* out_lengths) {
    auto* v = static_cast<Vocab*>(vocab_handle);
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    std::vector<std::string> toks;
    std::vector<int32_t> ids;
    for (int b = 0; b < n; ++b) {
        toks.clear();
        ids.clear();
        std::string text(texts[b]);
        for (auto& ch : text) ch = (char)std::tolower((unsigned char)ch);
        tokenize_one(text, toks);
        for (auto& t : toks) {
            auto it = v->map.find(t);
            int32_t id = it == v->map.end() ? v->unk : it->second;
            if (caption_drop_prob > 0 && uni(rng) <= caption_drop_prob)
                id = v->unk;
            ids.push_back(id);
        }
        if (caption_drop_prob > 0 && !ids.empty()) {
            int n_del = (int)(ids.size() * caption_drop_prob);
            for (int k = 0; k < n_del && !ids.empty(); ++k) {
                size_t pos = (size_t)(uni(rng) * ids.size());
                if (pos >= ids.size()) pos = ids.size() - 1;
                ids.erase(ids.begin() + pos);
            }
        }
        int32_t* row = out_ids + (size_t)b * max_len;
        std::memset(row, 0, sizeof(int32_t) * max_len);
        // Mirror the Python path's caption_to_ids(...)[:max_len] slice:
        // [<start>, body..., <end>] truncated — an overlong body keeps
        // its tokens and the <end> falls off, identical across paths.
        int32_t len = 0;
        row[len++] = v->start;
        for (int32_t id : ids) {
            if (len >= max_len) break;
            row[len++] = id;
        }
        if (len < max_len) row[len++] = v->end;
        out_lengths[b] = len;
    }
}

// ---------------------------------------------------------------------
// PNG: unfilter, de-interlace, expand to RGB
// ---------------------------------------------------------------------

static int png_channels(int color_type) {
    switch (color_type) {
        case 0: return 1;  // gray
        case 2: return 3;  // RGB
        case 3: return 1;  // palette
        case 4: return 2;  // gray + alpha
        case 6: return 4;  // RGBA
        default: return 0;
    }
}

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

// Sample `x` of an unfiltered row at `depth` bits (1, 2, 4, 8; 16 reads
// the high byte, which is all that PIL keeps of a 16-bit colour sample).
static inline int png_sample(const uint8_t* row, int64_t x, int depth) {
    if (depth == 8) return row[x];
    if (depth == 16) return row[2 * x];
    int64_t bit = x * depth;
    int shift = 8 - depth - (int)(bit & 7);
    return (row[bit >> 3] >> shift) & ((1 << depth) - 1);
}

// One unfiltered row of `width` pixels into the RGB pixels out[0],
// out[step], ... (3 bytes each), as PIL's convert("RGB") gives them: gray
// at 1 bit is 0 or 255, at 2 and 4 bits scaled by 85 and 17, at 16 bits
// clipped to 255 (PIL's I;16 -> RGB); other 16-bit samples keep their high
// byte; a palette index past the palette is black; alpha is dropped.
static void png_expand_row(const uint8_t* row, int64_t width, int depth,
                           int color_type, const uint8_t* palette,
                           int n_palette, uint8_t* out, int64_t step) {
    int ch = png_channels(color_type);
    for (int64_t x = 0; x < width; ++x) {
        uint8_t* o = out + x * step * 3;
        if (color_type == 3) {
            int i = png_sample(row, x, depth);
            if (i < n_palette) {
                o[0] = palette[3 * i];
                o[1] = palette[3 * i + 1];
                o[2] = palette[3 * i + 2];
            } else {
                o[0] = o[1] = o[2] = 0;
            }
            continue;
        }
        if (color_type == 0 || color_type == 4) {
            int v;
            if (depth == 16) {
                int hi = row[2 * ch * x], lo = row[2 * ch * x + 1];
                v = color_type == 0 ? std::min((hi << 8) | lo, 255) : hi;
            } else if (depth == 8) {
                v = row[ch * x];
            } else {
                v = png_sample(row, x, depth) * (255 / ((1 << depth) - 1));
            }
            o[0] = o[1] = o[2] = (uint8_t)v;
            continue;
        }
        for (int c = 0; c < 3; ++c)
            o[c] = depth == 16 ? row[2 * (ch * x + c)] : row[ch * x + c];
    }
}

// Unfilter `rows` rows of `row_bytes` bytes (each preceded in `src` by its
// filter type) into `dst`; `bpp`: bytes per complete pixel, at least 1.
// Returns 0, or 2 for an unknown filter type.
static int png_unfilter(const uint8_t* src, int64_t rows, int64_t row_bytes,
                        int bpp, uint8_t* dst) {
    for (int64_t y = 0; y < rows; ++y) {
        int filter = src[y * (row_bytes + 1)];
        const uint8_t* in = src + y * (row_bytes + 1) + 1;
        uint8_t* cur = dst + y * row_bytes;
        const uint8_t* up = y ? cur - row_bytes : nullptr;
        for (int64_t i = 0; i < row_bytes; ++i) {
            int a = i >= bpp ? cur[i - bpp] : 0;
            int b = up ? up[i] : 0;
            int c = (up && i >= bpp) ? up[i - bpp] : 0;
            int v = in[i];
            switch (filter) {
                case 0: break;
                case 1: v += a; break;
                case 2: v += b; break;
                case 3: v += (a + b) >> 1; break;
                case 4: v += paeth(a, b, c); break;
                default: return 2;
            }
            cur[i] = (uint8_t)v;
        }
    }
    return 0;
}

// The inflated IDAT stream `raw` of a PNG of width x height pixels into
// out (height x width x 3, RGB). interlace 1 is Adam7. Returns 0; 1 when
// the stream is shorter than the image needs; 2 for an unknown filter
// type; 3 for a colour type / bit depth PNG does not allow.
int png_decode(const uint8_t* raw, int64_t raw_len, int64_t width,
               int64_t height, int depth, int color_type, int interlace,
               const uint8_t* palette, int n_palette, uint8_t* out) {
    int ch = png_channels(color_type);
    if (ch == 0 || width < 1 || height < 1) return 3;
    bool ok = color_type == 0 ? (depth == 1 || depth == 2 || depth == 4 ||
                                 depth == 8 || depth == 16)
            : color_type == 3 ? (depth == 1 || depth == 2 || depth == 4 ||
                                 depth == 8)
            : (depth == 8 || depth == 16);
    if (!ok) return 3;
    int bpp = std::max(1, ch * depth / 8);
    static const int adam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8},
                                    {0, 4, 4, 8}, {2, 0, 4, 4},
                                    {0, 2, 2, 4}, {1, 0, 2, 2},
                                    {0, 1, 1, 2}};
    static const int whole[1][4] = {{0, 0, 1, 1}};
    const int (*passes)[4] = interlace ? adam7 : whole;
    int n_passes = interlace ? 7 : 1;
    std::vector<uint8_t> rows;
    int64_t pos = 0;
    for (int p = 0; p < n_passes; ++p) {
        int x0 = passes[p][0], y0 = passes[p][1];
        int dx = passes[p][2], dy = passes[p][3];
        int64_t pw = width > x0 ? (width - x0 + dx - 1) / dx : 0;
        int64_t ph = height > y0 ? (height - y0 + dy - 1) / dy : 0;
        if (pw == 0 || ph == 0) continue;  // an empty pass has no rows
        int64_t row_bytes = (pw * ch * depth + 7) / 8;
        if (pos + ph * (row_bytes + 1) > raw_len) return 1;
        rows.resize((size_t)(ph * row_bytes));
        int err = png_unfilter(raw + pos, ph, row_bytes, bpp, rows.data());
        if (err) return err;
        pos += ph * (row_bytes + 1);
        for (int64_t y = 0; y < ph; ++y)
            png_expand_row(rows.data() + y * row_bytes, pw, depth,
                           color_type, palette, n_palette,
                           out + ((y0 + y * dy) * width + x0) * 3, dx);
    }
    return 0;
}

// ---------------------------------------------------------------------
// GIF: one frame's LZW codes to RGB
// ---------------------------------------------------------------------

// The LZW data `data` (the frame's sub-blocks, concatenated) of a frame of
// fw x fh pixels at (left, top) of a sw x sh screen, into out (sh x sw x 3,
// RGB): the screen filled with palette entry `fill`, the frame's indices
// through `palette` (an index past it is black), rows in GIF's interlaced
// order when `interlaced`. Returns 0; 1 when the data ends before the frame
// is whole and without an end code; 2 for a code that is not in the table
// or a bad minimum code size; 3 for a frame outside the screen.
int gif_decode(const uint8_t* data, int64_t len, int min_code, int64_t sw,
               int64_t sh, int64_t left, int64_t top, int64_t fw,
               int64_t fh, int interlaced, const uint8_t* palette,
               int n_palette, int fill, uint8_t* out) {
    if (min_code < 1 || min_code > 11) return 2;
    if (left < 0 || top < 0 || left + fw > sw || top + fh > sh) return 3;
    auto colour = [&](int i, uint8_t* o) {
        if (i < n_palette) {
            o[0] = palette[3 * i];
            o[1] = palette[3 * i + 1];
            o[2] = palette[3 * i + 2];
        } else {
            o[0] = o[1] = o[2] = 0;
        }
    };
    uint8_t bg[3];
    colour(fill, bg);
    for (int64_t i = 0; i < sw * sh; ++i)
        std::memcpy(out + 3 * i, bg, 3);
    // Row of the screen that the frame's r-th stored row lands on.
    std::vector<int64_t> row_of(fh);
    if (interlaced) {
        int64_t r = 0;
        static const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
        for (int p = 0; p < 4; ++p)
            for (int64_t y = start[p]; y < fh; y += step[p]) row_of[r++] = y;
    } else {
        for (int64_t y = 0; y < fh; ++y) row_of[y] = y;
    }
    const int clear = 1 << min_code, eoi = clear + 1;
    std::vector<uint16_t> prefix(4096);
    std::vector<uint8_t> suffix(4096), stack(4097);
    for (int i = 0; i < clear; ++i) suffix[i] = (uint8_t)i;
    int size = min_code + 1, next = clear + 2, prev = -1, first = 0;
    const int64_t n_pix = fw * fh;
    int64_t produced = 0, bitpos = 0, total_bits = len * 8;
    auto emit = [&](int index) {
        if (produced >= n_pix) return;
        int64_t y = row_of[produced / fw], x = produced % fw;
        colour(index, out + ((top + y) * sw + left + x) * 3);
        ++produced;
    };
    while (produced < n_pix) {
        if (bitpos + size > total_bits) return 1;
        int code = 0;
        for (int b = 0; b < size; ++b, ++bitpos)
            code |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
        if (code == clear) {
            size = min_code + 1;
            next = clear + 2;
            prev = -1;
            continue;
        }
        if (code == eoi) return 0;
        if (prev < 0) {
            if (code >= clear) return 2;
            emit(code);
            prev = first = code;
            continue;
        }
        int cur = code, sp = 0;
        if (code == next) {  // the string of prev plus its own first byte
            stack[sp++] = (uint8_t)first;
            cur = prev;
        } else if (code > next) {
            return 2;
        }
        while (cur >= clear) {
            stack[sp++] = suffix[cur];
            cur = prefix[cur];
        }
        stack[sp++] = (uint8_t)cur;
        first = cur;
        while (sp) emit(stack[--sp]);
        if (next < 4096) {
            prefix[next] = (uint16_t)prev;
            suffix[next] = (uint8_t)first;
            ++next;
            if (next == (1 << size) && size < 12) ++size;
        }
        prev = code;
    }
    return 0;
}

}  // extern "C"

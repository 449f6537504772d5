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
// Plain C interface for ctypes (creamfl_tpu_torch/data/native.py), which
// builds it with g++ at first use (ops/build.py GXX_FLAGS). Host code
// only: nothing here runs on the card.

#include <cstdint>
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

}  // extern "C"

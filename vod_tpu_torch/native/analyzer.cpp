// Text analyzer + BM25 postings builder (native host-side hot path).
//
// Replaces the analysis/indexing work the reference delegates to
// Elasticsearch's Java analyzers (reference `vod_configs/utils/es_body.py`:
// lowercase, stopword filtering, language analyzers) and its bulk-indexing
// pipeline (`es_search/client.py:335`). Corpus analysis and postings
// construction are O(total tokens) and run once per corpus (and once per
// rebuild), so they live in C++; scoring runs on-device (vod_tpu/search/sparse).
//
// Exposed via a C ABI for ctypes (no pybind11 in this image):
//   analyze_batch  : texts -> hashed term ids (FNV-1a into a power-of-two space)
//   build_postings : per-doc term ids -> impact-ordered truncated BM25 postings
//
// Build: g++ -O3 -march=native -shared -fPIC analyzer.cpp -o libvodanalyzer.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 1469598103934665603ull;
constexpr uint64_t kFnvPrime = 1099511628211ull;

inline uint64_t fnv1a(const char* data, size_t n) {
  uint64_t h = kFnvOffset;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= kFnvPrime;
  }
  return h;
}

// Minimal English stopword list (parity: ES `_english_` stop filter).
const std::unordered_set<std::string>& stopwords() {
  static const std::unordered_set<std::string>* kSet = new std::unordered_set<std::string>{
      "a",    "an",   "and",  "are",  "as",   "at",   "be",   "but",  "by",
      "for",  "if",   "in",   "into", "is",   "it",   "no",   "not",  "of",
      "on",   "or",   "such", "that", "the",  "their", "then", "there", "these",
      "they", "this", "to",   "was",  "will", "with"};
  return *kSet;
}

// ---- Porter stemmer (Porter 1980) -----------------------------------------
// The ORIGINAL published algorithm, mirroring vod_tpu/native/porter.py token
// for token (parity-tested). Parity: ES language analyzers stem (reference
// `vod_configs/utils/es_body.py:32` — the English pipeline is
// lowercase -> stop -> porter_stem). ASCII lowercase input only; callers skip
// tokens containing non-ASCII bytes.

inline bool is_cons(const std::string& w, int i) {
  const char c = w[i];
  if (c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u') return false;
  if (c == 'y') return i == 0 || !is_cons(w, i - 1);
  return true;
}

inline int measure(const std::string& w, int n) {  // m over w[0:n]
  int m = 0, i = 0;
  while (i < n && is_cons(w, i)) ++i;
  while (i < n) {
    while (i < n && !is_cons(w, i)) ++i;
    if (i >= n) break;
    ++m;
    while (i < n && is_cons(w, i)) ++i;
  }
  return m;
}

inline bool has_vowel(const std::string& w, int n) {
  for (int i = 0; i < n; ++i)
    if (!is_cons(w, i)) return true;
  return false;
}

inline bool ends_double_cons(const std::string& w) {
  const int n = static_cast<int>(w.size());
  return n >= 2 && w[n - 1] == w[n - 2] && is_cons(w, n - 1);
}

inline bool ends_cvc(const std::string& w, int n) {  // *o over w[0:n]
  if (n < 3) return false;
  const char last = w[n - 1];
  return is_cons(w, n - 1) && !is_cons(w, n - 2) && is_cons(w, n - 3) &&
         last != 'w' && last != 'x' && last != 'y';
}

inline bool ends_with(const std::string& w, const char* suf) {
  const size_t sl = std::strlen(suf);
  return w.size() >= sl && std::memcmp(w.data() + w.size() - sl, suf, sl) == 0;
}

void porter_stem(std::string& w) {
  if (w.size() <= 2) return;

  // step 1a
  if (ends_with(w, "sses")) w.resize(w.size() - 2);
  else if (ends_with(w, "ies")) w.resize(w.size() - 2);
  else if (ends_with(w, "ss")) {}
  else if (ends_with(w, "s")) w.resize(w.size() - 1);

  // step 1b
  bool flag_1b = false;
  if (ends_with(w, "eed")) {
    if (measure(w, static_cast<int>(w.size()) - 3) > 0) w.resize(w.size() - 1);
  } else if (ends_with(w, "ed") && has_vowel(w, static_cast<int>(w.size()) - 2)) {
    w.resize(w.size() - 2);
    flag_1b = true;
  } else if (ends_with(w, "ing") && has_vowel(w, static_cast<int>(w.size()) - 3)) {
    w.resize(w.size() - 3);
    flag_1b = true;
  }
  if (flag_1b) {
    if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz")) {
      w.push_back('e');
    } else if (ends_double_cons(w) && w.back() != 'l' && w.back() != 's' && w.back() != 'z') {
      w.resize(w.size() - 1);
    } else if (measure(w, static_cast<int>(w.size())) == 1 &&
               ends_cvc(w, static_cast<int>(w.size()))) {
      w.push_back('e');
    }
  }

  // step 1c
  if (ends_with(w, "y") && has_vowel(w, static_cast<int>(w.size()) - 1)) w.back() = 'i';

  // steps 2 and 3: first matching suffix wins; replace iff m(stem) > 0
  struct Rule { const char* suf; const char* rep; };
  static const Rule kStep2[] = {
      {"ational", "ate"}, {"tional", "tion"}, {"enci", "ence"}, {"anci", "ance"},
      {"izer", "ize"}, {"abli", "able"}, {"alli", "al"}, {"entli", "ent"},
      {"eli", "e"}, {"ousli", "ous"}, {"ization", "ize"}, {"ation", "ate"},
      {"ator", "ate"}, {"alism", "al"}, {"iveness", "ive"}, {"fulness", "ful"},
      {"ousness", "ous"}, {"aliti", "al"}, {"iviti", "ive"}, {"biliti", "ble"}};
  static const Rule kStep3[] = {
      {"icate", "ic"}, {"ative", ""}, {"alize", "al"}, {"iciti", "ic"},
      {"ical", "ic"}, {"ful", ""}, {"ness", ""}};
  for (const auto& r : kStep2) {
    if (ends_with(w, r.suf)) {
      const int stem_n = static_cast<int>(w.size() - std::strlen(r.suf));
      if (measure(w, stem_n) > 0) { w.resize(stem_n); w.append(r.rep); }
      break;
    }
  }
  for (const auto& r : kStep3) {
    if (ends_with(w, r.suf)) {
      const int stem_n = static_cast<int>(w.size() - std::strlen(r.suf));
      if (measure(w, stem_n) > 0) { w.resize(stem_n); w.append(r.rep); }
      break;
    }
  }

  // step 4: drop iff m(stem) > 1 ("ion" additionally needs stem ending s|t)
  static const char* kStep4[] = {"al", "ance", "ence", "er", "ic", "able",
                                 "ible", "ant", "ement", "ment", "ent", "ion",
                                 "ou", "ism", "ate", "iti", "ous", "ive", "ize"};
  for (const char* suf : kStep4) {
    if (ends_with(w, suf)) {
      const int stem_n = static_cast<int>(w.size() - std::strlen(suf));
      if (measure(w, stem_n) > 1) {
        const bool ion = std::strcmp(suf, "ion") == 0;
        if (!ion || (stem_n > 0 && (w[stem_n - 1] == 's' || w[stem_n - 1] == 't'))) {
          w.resize(stem_n);
        }
      }
      break;
    }
  }

  // step 5a
  if (ends_with(w, "e")) {
    const int n1 = static_cast<int>(w.size()) - 1;
    const int m = measure(w, n1);
    if (m > 1 || (m == 1 && !ends_cvc(w, n1))) w.resize(n1);
  }
  // step 5b
  if (measure(w, static_cast<int>(w.size())) > 1 && ends_double_cons(w) && w.back() == 'l') {
    w.resize(w.size() - 1);
  }
}

inline bool is_ascii(const std::string& w) {
  for (const char c : w)
    if (static_cast<unsigned char>(c) >= 0x80) return false;
  return true;
}

// ---- Snowball German + Spanish stemmers ------------------------------------
// Mirror vod_tpu/native/snowball.py token for token (parity-tested in
// tests/test_stemming.py). Implemented over decoded codepoints: the suffix
// systems of both languages involve non-ASCII letters (ä ö ü ß, á é í ó ú).

using u32 = std::u32string;

inline u32 utf8_decode(const std::string& s) {
  u32 out;
  out.reserve(s.size());
  size_t i = 0;
  while (i < s.size()) {
    const unsigned char c = s[i];
    char32_t cp = 0;
    int extra = 0;
    if (c < 0x80) { cp = c; }
    else if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; extra = 1; }
    else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; extra = 2; }
    else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; extra = 3; }
    else { ++i; continue; }  // invalid byte: skip
    if (i + extra >= s.size() + (extra == 0 ? 1 : 0)) { break; }
    bool ok = true;
    for (int j = 1; j <= extra; ++j) {
      const unsigned char cc = s[i + j];
      if ((cc & 0xC0) != 0x80) { ok = false; break; }
      cp = (cp << 6) | (cc & 0x3F);
    }
    if (!ok) { ++i; continue; }
    out.push_back(cp);
    i += 1 + extra;
  }
  return out;
}

inline void utf8_encode(const u32& w, std::string& out) {
  out.clear();
  for (const char32_t cp : w) {
    if (cp < 0x80) out.push_back(static_cast<char>(cp));
    else if (cp < 0x800) {
      out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
  }
}

inline bool u32_ends(const u32& w, const char32_t* suf) {
  size_t sl = 0;
  while (suf[sl]) ++sl;
  if (w.size() < sl) return false;
  return std::char_traits<char32_t>::compare(w.data() + w.size() - sl, suf, sl) == 0;
}

// -- German ------------------------------------------------------------------

inline bool de_vowel(char32_t c) {
  return c == U'a' || c == U'e' || c == U'i' || c == U'o' || c == U'u' ||
         c == U'y' || c == 0xE4 || c == 0xF6 || c == 0xFC;  // ä ö ü
}

inline void de_regions(const u32& w, int* r1, int* r2) {
  const int n = static_cast<int>(w.size());
  auto next_region = [&](int start) {
    int i = start;
    while (i < n && !de_vowel(w[i])) ++i;
    while (i < n && de_vowel(w[i])) ++i;
    return i < n ? std::min(i + 1, n) : n;
  };
  *r1 = next_region(0);
  *r2 = next_region(*r1);
  if (*r1 < 3) *r1 = std::min(3, n);
}

inline bool de_s_ending(char32_t c) {
  return c == U'b' || c == U'd' || c == U'f' || c == U'g' || c == U'h' ||
         c == U'k' || c == U'l' || c == U'm' || c == U'n' || c == U'r' || c == U't';
}

inline bool de_st_ending(char32_t c) { return de_s_ending(c) && c != U'r'; }

void german_stem(u32& w) {
  // ß -> ss
  u32 tmp;
  tmp.reserve(w.size() + 2);
  for (const char32_t c : w) {
    if (c == 0xDF) { tmp.push_back(U's'); tmp.push_back(U's'); }
    else tmp.push_back(c);
  }
  w.swap(tmp);
  const int n = static_cast<int>(w.size());
  auto de_umlaut = [&]() {
    for (auto& c : w) {
      if (c == 0xE4) c = U'a';
      else if (c == 0xF6) c = U'o';
      else if (c == 0xFC) c = U'u';
    }
  };
  if (n <= 2) { de_umlaut(); return; }

  // u/y between vowels are consonants: mark upper-case
  for (int i = 1; i < n - 1; ++i) {
    if ((w[i] == U'u' || w[i] == U'y') && de_vowel(w[i - 1]) && de_vowel(w[i + 1])) {
      w[i] = w[i] - 32;  // 'u'->'U', 'y'->'Y' (not in de_vowel => consonants)
    }
  }
  int r1, r2;
  de_regions(w, &r1, &r2);
  auto in_r1 = [&](int pos) { return pos >= r1; };
  auto in_r2 = [&](int pos) { return pos >= r2; };

  // step 1
  bool done = false;
  static const char32_t* kStep1a[] = {U"ern", U"em", U"er"};
  static const char32_t* kStep1b[] = {U"en", U"es", U"e"};
  for (const char32_t* suf : kStep1a) {
    if (u32_ends(w, suf)) {
      const int sl = static_cast<int>(std::char_traits<char32_t>::length(suf));
      if (in_r1(static_cast<int>(w.size()) - sl)) w.resize(w.size() - sl);
      done = true;
      break;
    }
  }
  if (!done) {
    for (const char32_t* suf : kStep1b) {
      if (u32_ends(w, suf)) {
        const int sl = static_cast<int>(std::char_traits<char32_t>::length(suf));
        if (in_r1(static_cast<int>(w.size()) - sl)) {
          w.resize(w.size() - sl);
          if (u32_ends(w, U"niss")) w.resize(w.size() - 1);
        }
        done = true;
        break;
      }
    }
  }
  if (!done && u32_ends(w, U"s")) {
    if (in_r1(static_cast<int>(w.size()) - 1) && w.size() >= 2 && de_s_ending(w[w.size() - 2])) {
      w.resize(w.size() - 1);
    }
  }

  // step 2
  done = false;
  static const char32_t* kStep2[] = {U"est", U"en", U"er"};
  for (const char32_t* suf : kStep2) {
    if (u32_ends(w, suf)) {
      const int sl = static_cast<int>(std::char_traits<char32_t>::length(suf));
      if (in_r1(static_cast<int>(w.size()) - sl)) w.resize(w.size() - sl);
      done = true;
      break;
    }
  }
  if (!done && u32_ends(w, U"st")) {
    if (in_r1(static_cast<int>(w.size()) - 2) && w.size() >= 6 && de_st_ending(w[w.size() - 3])) {
      w.resize(w.size() - 2);
    }
  }

  // step 3 (d-suffixes)
  if (u32_ends(w, U"end") || u32_ends(w, U"ung")) {
    if (in_r2(static_cast<int>(w.size()) - 3)) {
      w.resize(w.size() - 3);
      if (u32_ends(w, U"ig") && !u32_ends(w, U"eig") && in_r2(static_cast<int>(w.size()) - 2)) {
        w.resize(w.size() - 2);
      }
    }
  } else if (u32_ends(w, U"ig") || u32_ends(w, U"ik")) {
    const int pos = static_cast<int>(w.size()) - 2;
    if (in_r2(pos) && (pos == 0 || w[pos - 1] != U'e')) w.resize(pos);
  } else if (u32_ends(w, U"isch")) {
    const int pos = static_cast<int>(w.size()) - 4;
    if (in_r2(pos) && (pos == 0 || w[pos - 1] != U'e')) w.resize(pos);
  } else if (u32_ends(w, U"lich") || u32_ends(w, U"heit")) {
    if (in_r2(static_cast<int>(w.size()) - 4)) {
      w.resize(w.size() - 4);
      if (u32_ends(w, U"er") && in_r1(static_cast<int>(w.size()) - 2)) w.resize(w.size() - 2);
      else if (u32_ends(w, U"en") && in_r1(static_cast<int>(w.size()) - 2)) w.resize(w.size() - 2);
    }
  } else if (u32_ends(w, U"keit")) {
    if (in_r2(static_cast<int>(w.size()) - 4)) {
      w.resize(w.size() - 4);
      if (u32_ends(w, U"lich") && in_r2(static_cast<int>(w.size()) - 4)) w.resize(w.size() - 4);
      else if (u32_ends(w, U"ig") && in_r2(static_cast<int>(w.size()) - 2)) w.resize(w.size() - 2);
    }
  }

  // finally: unmark U/Y, remove umlauts
  for (auto& c : w) {
    if (c == U'U') c = U'u';
    else if (c == U'Y') c = U'y';
  }
  de_umlaut();
}

// -- Spanish -------------------------------------------------------------------

inline bool es_vowel(char32_t c) {
  return c == U'a' || c == U'e' || c == U'i' || c == U'o' || c == U'u' ||
         c == 0xE1 || c == 0xE9 || c == 0xED || c == 0xF3 || c == 0xFA ||
         c == 0xFC;  // á é í ó ú ü
}

inline int es_rv(const u32& w) {
  const int n = static_cast<int>(w.size());
  if (n < 3) return n;
  if (!es_vowel(w[1])) {
    int i = 2;
    while (i < n && !es_vowel(w[i])) ++i;
    return std::min(i + 1, n);
  }
  if (es_vowel(w[0]) && es_vowel(w[1])) {
    int i = 2;
    while (i < n && es_vowel(w[i])) ++i;
    return std::min(i + 1, n);
  }
  return 3;
}

inline void es_regions(const u32& w, int* r1, int* r2) {
  const int n = static_cast<int>(w.size());
  auto next_region = [&](int start) {
    int i = start;
    while (i < n && !es_vowel(w[i])) ++i;
    while (i < n && es_vowel(w[i])) ++i;
    return i < n ? std::min(i + 1, n) : n;
  };
  *r1 = next_region(0);
  *r2 = next_region(*r1);
}

struct EsRule { const char32_t* suf; int action; };
// actions: 0=del(r2) 1=del_ic(r2) 2=log(r2) 3=u(r2) 4=ente(r2) 5=amente(r1)
//          6=mente(r2) 7=idad(r2) 8=iv(r2)
static const EsRule kEsStep1[] = {
    {U"amientos", 0}, {U"imientos", 0}, {U"amiento", 0}, {U"imiento", 0},
    {U"anzas", 0}, {U"ismos", 0}, {U"ables", 0}, {U"ibles", 0}, {U"istas", 0},
    {U"anza", 0}, {U"icos", 0}, {U"icas", 0}, {U"ismo", 0}, {U"able", 0},
    {U"ible", 0}, {U"ista", 0}, {U"osos", 0}, {U"osas", 0}, {U"ico", 0},
    {U"ica", 0}, {U"oso", 0}, {U"osa", 0},
    {U"aciones", 1}, {U"adoras", 1}, {U"adores", 1}, {U"ancias", 1},
    {U"adora", 1}, {U"ación", 1}, {U"antes", 1}, {U"ancia", 1},
    {U"ador", 1}, {U"ante", 1},
    {U"logías", 2}, {U"logía", 2},
    {U"uciones", 3}, {U"ución", 3},
    {U"encias", 4}, {U"encia", 4},
    {U"amente", 5}, {U"mente", 6},
    {U"idades", 7}, {U"idad", 7},
    {U"ivas", 8}, {U"ivos", 8}, {U"iva", 8}, {U"ivo", 8},
};

static const char32_t* kEsPron[] = {
    U"selas", U"selos", U"sela", U"selo", U"las", U"les", U"los", U"nos",
    U"me", U"se", U"la", U"le", U"lo"};
static const char32_t* kEsPronA[] = {U"iéndo", U"ándo", U"ár", U"ér", U"ír"};
static const char32_t* kEsPronAFix[] = {U"iendo", U"ando", U"ar", U"er", U"ir"};
static const char32_t* kEsPronB[] = {U"iendo", U"ando", U"ar", U"er", U"ir"};

static const char32_t* kEsStep2bGu[] = {U"en", U"es", U"éis", U"emos"};
static const char32_t* kEsStep2b[] = {
    U"aríamos", U"eríamos", U"iríamos", U"iéramos", U"iésemos",
    U"aríais", U"aseis", U"eríais", U"iríais", U"ieseis", U"asteis",
    U"isteis", U"ábamos", U"áramos", U"ásemos", U"arían",
    U"arías", U"aréis", U"erían", U"erías", U"eréis",
    U"irían", U"irías", U"iréis", U"ieran", U"iesen", U"ieron",
    U"iendo", U"ieras", U"ieses", U"abais", U"arais", U"íamos", U"emos",
    U"arán", U"arás", U"aría", U"erán", U"erás",
    U"ería", U"irán", U"irás", U"iría", U"iera", U"iese",
    U"aste", U"iste", U"aban", U"aran", U"asen", U"aron", U"ando", U"abas",
    U"adas", U"idas", U"aras", U"ases", U"íais", U"ados", U"idos", U"amos",
    U"imos", U"ían", U"ado", U"ido", U"ías", U"áis", U"ía",
    U"ad", U"ed", U"id", U"an", U"ió", U"ar", U"er", U"ir", U"as",
    U"ís"};
static const char32_t* kEsStep3Gu[] = {U"e", U"é"};
static const char32_t* kEsStep3[] = {U"os", U"a", U"o", U"á", U"í", U"ó"};

inline size_t u32_len(const char32_t* s) { return std::char_traits<char32_t>::length(s); }

void spanish_stem(u32& w) {
  const int rv = es_rv(w);
  int r1, r2;
  es_regions(w, &r1, &r2);
  auto in_rv = [&](int pos) { return pos >= rv; };
  auto in_r1 = [&](int pos) { return pos >= r1; };
  auto in_r2 = [&](int pos) { return pos >= r2; };

  // step 0: attached pronoun (longest pronoun match only)
  for (const char32_t* pron : kEsPron) {
    if (!u32_ends(w, pron)) continue;
    u32 base = w.substr(0, w.size() - u32_len(pron));
    bool matched = false;
    for (int a = 0; a < 5; ++a) {
      const size_t al = u32_len(kEsPronA[a]);
      if (base.size() >= al && u32_ends(base, kEsPronA[a]) &&
          in_rv(static_cast<int>(base.size() - al))) {
        w = base.substr(0, base.size() - al);
        w.append(kEsPronAFix[a]);
        matched = true;
        break;
      }
    }
    if (!matched) {
      for (const char32_t* b : kEsPronB) {
        const size_t bl = u32_len(b);
        if (base.size() >= bl && u32_ends(base, b) &&
            in_rv(static_cast<int>(base.size() - bl))) {
          w = base;
          matched = true;
          break;
        }
      }
    }
    if (!matched && u32_ends(base, U"yendo") && base.size() >= 6 &&
        base[base.size() - 6] == U'u') {
      w = base;
    }
    break;
  }

  const size_t n0 = w.size();
  // step 1: standard suffixes, longest match across all groups
  const EsRule* best = nullptr;
  size_t best_len = 0;
  for (const auto& r : kEsStep1) {
    const size_t sl = u32_len(r.suf);
    if (sl > best_len && u32_ends(w, r.suf)) { best = &r; best_len = sl; }
  }
  bool step1_done = false;
  if (best != nullptr) {
    const int pos = static_cast<int>(w.size() - best_len);
    const bool ok = (best->action == 5) ? in_r1(pos) : in_r2(pos);
    if (ok) {
      step1_done = true;
      switch (best->action) {
        case 0: w.resize(pos); break;
        case 1:
          w.resize(pos);
          if (u32_ends(w, U"ic") && in_r2(static_cast<int>(w.size()) - 2)) w.resize(w.size() - 2);
          break;
        case 2: w.resize(pos); w.append(U"log"); break;
        case 3: w.resize(pos); w.append(U"u"); break;
        case 4: w.resize(pos); w.append(U"ente"); break;
        case 5:
          w.resize(pos);
          if (u32_ends(w, U"iv") && in_r2(static_cast<int>(w.size()) - 2)) {
            w.resize(w.size() - 2);
            if (u32_ends(w, U"at") && in_r2(static_cast<int>(w.size()) - 2)) w.resize(w.size() - 2);
          } else {
            static const char32_t* kPre[] = {U"os", U"ic", U"ad"};
            for (const char32_t* pre : kPre) {
              if (u32_ends(w, pre) && in_r2(static_cast<int>(w.size()) - 2)) {
                w.resize(w.size() - 2);
                break;
              }
            }
          }
          break;
        case 6: {
          w.resize(pos);
          static const char32_t* kPre[] = {U"ante", U"able", U"ible"};
          for (const char32_t* pre : kPre) {
            if (u32_ends(w, pre) && in_r2(static_cast<int>(w.size()) - 4)) {
              w.resize(w.size() - 4);
              break;
            }
          }
          break;
        }
        case 7: {
          w.resize(pos);
          static const char32_t* kPre[] = {U"abil", U"ic", U"iv"};
          for (const char32_t* pre : kPre) {
            const size_t pl = u32_len(pre);
            if (u32_ends(w, pre) && in_r2(static_cast<int>(w.size() - pl))) {
              w.resize(w.size() - pl);
              break;
            }
          }
          break;
        }
        case 8:
          w.resize(pos);
          if (u32_ends(w, U"at") && in_r2(static_cast<int>(w.size()) - 2)) w.resize(w.size() - 2);
          break;
      }
    }
  }

  // step 2a / 2b (only if step 1 removed nothing)
  if (!step1_done && w.size() == n0) {
    static const char32_t* kStep2a[] = {
        U"yeron", U"yendo", U"yamos", U"yais", U"yan", U"yen", U"yas",
        U"yes", U"ya", U"ye", U"yo", U"yó"};
    for (const char32_t* suf : kStep2a) {
      if (u32_ends(w, suf)) {
        const int pos = static_cast<int>(w.size() - u32_len(suf));
        if (in_rv(pos) && pos > 0 && w[pos - 1] == U'u') w.resize(pos);
        break;
      }
    }
    if (w.size() == n0) {
      const char32_t* matched = nullptr;
      size_t ml = 0;
      bool matched_gu = false;
      for (const char32_t* suf : kEsStep2bGu) {
        const size_t sl = u32_len(suf);
        if (sl > ml && u32_ends(w, suf)) { matched = suf; ml = sl; matched_gu = true; }
      }
      for (const char32_t* suf : kEsStep2b) {
        const size_t sl = u32_len(suf);
        if (sl > ml && u32_ends(w, suf)) { matched = suf; ml = sl; matched_gu = false; }
      }
      if (matched != nullptr && in_rv(static_cast<int>(w.size() - ml))) {
        w.resize(w.size() - ml);
        if (matched_gu && u32_ends(w, U"gu")) w.resize(w.size() - 1);
      }
    }
  }

  // step 3: residual suffix
  {
    const char32_t* matched = nullptr;
    size_t ml = 0;
    bool matched_gu = false;
    for (const char32_t* suf : kEsStep3Gu) {
      const size_t sl = u32_len(suf);
      if (sl > ml && u32_ends(w, suf)) { matched = suf; ml = sl; matched_gu = true; }
    }
    for (const char32_t* suf : kEsStep3) {
      const size_t sl = u32_len(suf);
      if (sl > ml && u32_ends(w, suf)) { matched = suf; ml = sl; matched_gu = false; }
    }
    if (matched != nullptr && in_rv(static_cast<int>(w.size() - ml))) {
      w.resize(w.size() - ml);
      if (matched_gu && u32_ends(w, U"gu") && in_rv(static_cast<int>(w.size()) - 1)) {
        w.resize(w.size() - 1);
      }
    }
  }

  // finally: remove acute accents
  for (auto& c : w) {
    if (c == 0xE1) c = U'a';
    else if (c == 0xE9) c = U'e';
    else if (c == 0xED) c = U'i';
    else if (c == 0xF3) c = U'o';
    else if (c == 0xFA) c = U'u';
  }
}

// -- French (classic Snowball spec; mirrors snowball.py french_stem) ----------

inline bool fr_vowel(char32_t c) {
  return c == U'a' || c == U'e' || c == U'i' || c == U'o' || c == U'u' ||
         c == U'y' || c == 0xE2 || c == 0xE0 || c == 0xEB || c == 0xE9 ||
         c == 0xEA || c == 0xE8 || c == 0xEF || c == 0xEE || c == 0xF4 ||
         c == 0xFB || c == 0xF9;  // â à ë é ê è ï î ô û ù
}

// u/i between vowels, y next to a vowel, u after q -> marker uppercase,
// left-to-right over the current (partially marked) string
inline void fr_mark(u32& w) {
  const int n = static_cast<int>(w.size());
  for (int i = 0; i < n; ++i) {
    const char32_t c = w[i];
    if (c == U'u' && i > 0 && w[i - 1] == U'q') w[i] = U'U';
    else if ((c == U'u' || c == U'i') && i > 0 && i < n - 1 &&
             fr_vowel(w[i - 1]) && fr_vowel(w[i + 1]))
      w[i] = (c == U'u') ? U'U' : U'I';
    else if (c == U'y' && ((i > 0 && fr_vowel(w[i - 1])) ||
                           (i < n - 1 && fr_vowel(w[i + 1]))))
      w[i] = U'Y';
  }
}

inline int fr_rv(const u32& w) {
  const int n = static_cast<int>(w.size());
  if (n >= 3) {
    const u32 head = w.substr(0, 3);
    if (head == U"par" || head == U"col" || head == U"tap") return 3;
  }
  if (n >= 2 && fr_vowel(w[0]) && fr_vowel(w[1])) return std::min(3, n);
  for (int i = 1; i < n; ++i)
    if (fr_vowel(w[i])) return i + 1;
  return n;
}

inline void fr_regions(const u32& w, int* r1, int* r2) {
  const int n = static_cast<int>(w.size());
  auto next_region = [&](int start) {
    int i = start;
    while (i < n && !fr_vowel(w[i])) ++i;
    while (i < n && fr_vowel(w[i])) ++i;
    return i < n ? std::min(i + 1, n) : n;
  };
  *r1 = next_region(0);
  *r2 = next_region(*r1);
}

struct FrRule { const char32_t* suf; int action; };
// actions: 0=del(r2) 1=del_r2+ic 2=log 3=u 4=ent 5=ement 6=ité 7=if
//          8=eaux 9=aux 10=euse 11=issement 12=amment 13=emment 14=ment
static const FrRule kFrStep1[] = {
    {U"ances", 0}, {U"iqUes", 0}, {U"ismes", 0}, {U"ables", 0}, {U"istes", 0},
    {U"ance", 0}, {U"iqUe", 0}, {U"isme", 0}, {U"able", 0}, {U"iste", 0},
    {U"eux", 0},
    {U"atrices", 1}, {U"ateurs", 1}, {U"ations", 1}, {U"atrice", 1},
    {U"ateur", 1}, {U"ation", 1},
    {U"logies", 2}, {U"logie", 2},
    {U"usions", 3}, {U"utions", 3}, {U"usion", 3}, {U"ution", 3},
    {U"ences", 4}, {U"ence", 4},
    {U"ements", 5}, {U"ement", 5},
    {U"ités", 6}, {U"ité", 6},
    {U"ives", 7}, {U"ifs", 7}, {U"ive", 7}, {U"if", 7},
    {U"eaux", 8}, {U"aux", 9},
    {U"euses", 10}, {U"euse", 10},
    {U"issements", 11}, {U"issement", 11},
    {U"amment", 12}, {U"emment", 13},
    {U"ments", 14}, {U"ment", 14},
};

static const char32_t* kFrStep2a[] = {
    U"issaIent", U"issantes", U"iraIent", U"issante", U"issants", U"issions",
    U"irions", U"issais", U"issait", U"issant", U"issent", U"issiez",
    U"issons", U"irais", U"irait", U"irent", U"iriez", U"irons", U"iront",
    U"isses", U"issez", U"îmes", U"îtes", U"irai", U"iras", U"irez",
    U"isse", U"ies", U"ira", U"ît", U"ie", U"ir", U"is", U"it", U"i"};
static const char32_t* kFrStep2bE[] = {
    U"eraIent", U"erions", U"èrent", U"erais", U"erait", U"erez", U"eriez",
    U"erons", U"eront", U"erai", U"eras", U"ées", U"era", U"iez", U"ée",
    U"és", U"er", U"ez", U"é"};
static const char32_t* kFrStep2bA[] = {
    U"assions", U"assiez", U"assent", U"antes", U"asses", U"aIent",
    U"âtes", U"âmes", U"asse", U"ante", U"ants", U"ais", U"ait", U"ant",
    U"ât", U"as", U"ai", U"a"};

void french_stem(u32& w) {
  fr_mark(w);
  const int rv = fr_rv(w);
  int r1, r2;
  fr_regions(w, &r1, &r2);
  auto in_rv = [&](int pos) { return pos >= rv; };
  auto in_r1 = [&](int pos) { return pos >= r1; };
  auto in_r2 = [&](int pos) { return pos >= r2; };

  const u32 w0 = w;
  // step 1: standard suffix removal (longest match over all groups)
  const FrRule* best = nullptr;
  size_t best_len = 0;
  for (const auto& r : kFrStep1) {
    const size_t sl = u32_len(r.suf);
    if (sl > best_len && u32_ends(w, r.suf)) { best = &r; best_len = sl; }
  }
  const bool ment_family = best != nullptr && (best->action >= 12);
  if (best != nullptr) {
    const int pos = static_cast<int>(w.size() - best_len);
    switch (best->action) {
      case 0:
        if (in_r2(pos)) w.resize(pos);
        break;
      case 1:
        if (in_r2(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"ic")) {
            if (in_r2(static_cast<int>(w.size()) - 2)) w.resize(w.size() - 2);
            else { w.resize(w.size() - 2); w.append(U"iqU"); }
          }
        }
        break;
      case 2:
        if (in_r2(pos)) { w.resize(pos); w.append(U"log"); }
        break;
      case 3:
        if (in_r2(pos)) { w.resize(pos); w.append(U"u"); }
        break;
      case 4:
        if (in_r2(pos)) { w.resize(pos); w.append(U"ent"); }
        break;
      case 5:  // ement/ements
        if (in_rv(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"iv") && in_r2(static_cast<int>(w.size()) - 2)) {
            w.resize(w.size() - 2);
            if (u32_ends(w, U"at") && in_r2(static_cast<int>(w.size()) - 2))
              w.resize(w.size() - 2);
          } else if (u32_ends(w, U"eus")) {
            if (in_r2(static_cast<int>(w.size()) - 3)) w.resize(w.size() - 3);
            else if (in_r1(static_cast<int>(w.size()) - 3)) {
              w.resize(w.size() - 3); w.append(U"eux");
            }
          } else if ((u32_ends(w, U"abl") || u32_ends(w, U"iqU")) &&
                     in_r2(static_cast<int>(w.size()) - 3)) {
            w.resize(w.size() - 3);
          } else if ((u32_ends(w, U"ièr") || u32_ends(w, U"Ièr")) &&
                     in_rv(static_cast<int>(w.size()) - 3)) {
            w.resize(w.size() - 3); w.append(U"i");
          }
        }
        break;
      case 6:  // ité/ités
        if (in_r2(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"abil")) {
            if (in_r2(static_cast<int>(w.size()) - 4)) w.resize(w.size() - 4);
            else { w.resize(w.size() - 4); w.append(U"abl"); }
          } else if (u32_ends(w, U"ic")) {
            if (in_r2(static_cast<int>(w.size()) - 2)) w.resize(w.size() - 2);
            else { w.resize(w.size() - 2); w.append(U"iqU"); }
          } else if (u32_ends(w, U"iv") && in_r2(static_cast<int>(w.size()) - 2)) {
            w.resize(w.size() - 2);
          }
        }
        break;
      case 7:  // if/ive/ifs/ives
        if (in_r2(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"at") && in_r2(static_cast<int>(w.size()) - 2)) {
            w.resize(w.size() - 2);
            if (u32_ends(w, U"ic")) {
              if (in_r2(static_cast<int>(w.size()) - 2)) w.resize(w.size() - 2);
              else { w.resize(w.size() - 2); w.append(U"iqU"); }
            }
          }
        }
        break;
      case 8:
        w.resize(pos); w.append(U"eau");
        break;
      case 9:
        if (in_r1(pos)) { w.resize(pos); w.append(U"al"); }
        break;
      case 10:
        if (in_r2(pos)) w.resize(pos);
        else if (in_r1(pos)) { w.resize(pos); w.append(U"eux"); }
        break;
      case 11:
        if (in_r1(pos) && pos > 0 && !fr_vowel(w[pos - 1])) w.resize(pos);
        break;
      case 12:
        if (in_rv(pos)) { w.resize(pos); w.append(U"ant"); }
        break;
      case 13:
        if (in_rv(pos)) { w.resize(pos); w.append(U"ent"); }
        break;
      case 14:
        if (pos > 0 && in_rv(pos - 1) && fr_vowel(w[pos - 1])) w.resize(pos);
        break;
    }
  }

  bool changed = w != w0;
  // step 2a: verb suffixes beginning i (gated per spec)
  if (!changed || ment_family) {
    const u32 w1 = w;
    const char32_t* m2a = nullptr;
    size_t ml = 0;
    for (const char32_t* suf : kFrStep2a) {
      const size_t sl = u32_len(suf);
      if (sl > ml && u32_ends(w, suf)) { m2a = suf; ml = sl; }
    }
    if (m2a != nullptr) {
      const int pos = static_cast<int>(w.size() - ml);
      if (in_rv(pos) && pos > 0 && in_rv(pos - 1) && !fr_vowel(w[pos - 1]))
        w.resize(pos);
    }
    if (w == w1) {  // step 2b (only if 2a removed nothing)
      const char32_t* m2b = nullptr;
      int act = -1;  // 0=ions 1=e-group 2=a-group
      size_t bl = 0;
      if (u32_ends(w, U"ions")) { m2b = U"ions"; act = 0; bl = 4; }
      for (const char32_t* suf : kFrStep2bE) {
        const size_t sl = u32_len(suf);
        if (sl > bl && u32_ends(w, suf)) { m2b = suf; act = 1; bl = sl; }
      }
      for (const char32_t* suf : kFrStep2bA) {
        const size_t sl = u32_len(suf);
        if (sl > bl && u32_ends(w, suf)) { m2b = suf; act = 2; bl = sl; }
      }
      if (m2b != nullptr) {
        const int pos = static_cast<int>(w.size() - bl);
        if (act == 0) {
          if (in_rv(pos) && in_r2(pos)) w.resize(pos);
        } else if (act == 1) {
          if (in_rv(pos)) w.resize(pos);
        } else {
          if (in_rv(pos)) {
            w.resize(pos);
            if (u32_ends(w, U"e") && in_rv(static_cast<int>(w.size()) - 1))
              w.resize(w.size() - 1);
          }
        }
      }
    }
    changed = w != w0;
  }

  if (changed) {
    // step 3
    if (!w.empty() && w.back() == U'Y') w.back() = U'i';
    else if (!w.empty() && w.back() == 0xE7) w.back() = U'c';
  } else {
    // step 4: residual suffix
    if (w.size() >= 2 && w.back() == U's') {
      const char32_t p = w[w.size() - 2];
      if (p != U'a' && p != U'i' && p != U'o' && p != U'u' && p != 0xE8 &&
          p != U's')
        w.resize(w.size() - 1);
    }
    const char32_t* m4 = nullptr;
    size_t ml = 0;
    for (const char32_t* suf :
         {U"ière", U"Ière", U"ion", U"ier", U"Ier", U"ë", U"e"}) {
      const size_t sl = u32_len(suf);
      if (sl > ml && u32_ends(w, suf)) { m4 = suf; ml = sl; }
    }
    if (m4 != nullptr) {
      const int pos = static_cast<int>(w.size() - ml);
      if (std::char_traits<char32_t>::compare(m4, U"ion", 4) == 0) {
        if (in_rv(pos) && in_r2(pos) && pos > 0 && in_rv(pos - 1) &&
            (w[pos - 1] == U's' || w[pos - 1] == U't'))
          w.resize(pos);
      } else if (ml == 4 || ml == 3) {  // ière/Ière/ier/Ier
        if (in_rv(pos)) { w.resize(pos); w.append(U"i"); }
      } else if (m4[0] == U'e') {
        if (in_rv(pos)) w.resize(pos);
      } else {  // ë
        if (in_rv(pos) && u32_ends(w, U"guë")) w.resize(pos);
      }
    }
  }

  // step 5: undouble
  if (u32_ends(w, U"enn") || u32_ends(w, U"onn") || u32_ends(w, U"ett") ||
      u32_ends(w, U"ell") || u32_ends(w, U"eill"))
    w.resize(w.size() - 1);
  // step 6: un-accent (é/è followed by >=1 non-vowel at the end)
  {
    int i = static_cast<int>(w.size()) - 1;
    int cnt = 0;
    while (i >= 0 && !fr_vowel(w[i])) { --i; ++cnt; }
    if (cnt >= 1 && i >= 0 && (w[i] == 0xE9 || w[i] == 0xE8)) w[i] = U'e';
  }
  // unmark
  for (auto& c : w) {
    if (c == U'I') c = U'i';
    else if (c == U'U') c = U'u';
    else if (c == U'Y') c = U'y';
  }
}

// -- Russian (Snowball russian stemmer; mirrors snowball.py russian_stem) ----

inline bool ru_vowel(char32_t c) {
  return c == U'а' || c == U'е' || c == U'и' || c == U'о' || c == U'у' ||
         c == U'ы' || c == U'э' || c == U'ю' || c == U'я';
}

static const char32_t* kRuPerfGerund1[] = {U"вшись", U"вши", U"в"};
static const char32_t* kRuPerfGerund2[] = {U"ившись", U"ывшись", U"ивши",
                                           U"ывши", U"ив", U"ыв"};
static const char32_t* kRuAdjective[] = {
    U"ими", U"ыми", U"его", U"ого", U"ему", U"ому", U"ее", U"ие", U"ые",
    U"ое", U"ей", U"ий", U"ый", U"ой", U"ем", U"им", U"ым", U"ом", U"их",
    U"ых", U"ую", U"юю", U"ая", U"яя", U"ою", U"ею"};
static const char32_t* kRuParticiple1[] = {U"ющ", U"нн", U"вш", U"ем", U"щ"};
static const char32_t* kRuParticiple2[] = {U"ивш", U"ывш", U"ующ"};
static const char32_t* kRuVerb1[] = {
    U"ешь", U"нно", U"ете", U"йте", U"ла", U"на", U"ли", U"ем", U"ло",
    U"но", U"ет", U"ют", U"ны", U"ть", U"й", U"л", U"н"};
static const char32_t* kRuVerb2[] = {
    U"ейте", U"уйте", U"ила", U"ыла", U"ена", U"ите", U"или", U"ыли",
    U"ило", U"ыло", U"ено", U"ует", U"уют", U"ены", U"ить", U"ыть",
    U"ишь", U"ей", U"уй", U"ил", U"ыл", U"им", U"ым", U"ен", U"ят",
    U"ит", U"ыт", U"ую", U"ю"};
static const char32_t* kRuNoun[] = {
    U"иями", U"ями", U"ами", U"ией", U"иям", U"ием", U"иях", U"ев", U"ов",
    U"ие", U"ье", U"еи", U"ии", U"ей", U"ой", U"ий", U"ям", U"ем", U"ам",
    U"ом", U"ах", U"ях", U"ию", U"ью", U"ия", U"ья", U"а", U"е", U"и",
    U"й", U"о", U"у", U"ы", U"ь", U"ю", U"я"};

// longest suffix whose start lies in RV; nullptr if none
template <size_t N>
inline const char32_t* ru_longest(const u32& w, const char32_t* (&sufs)[N], int rv) {
  const char32_t* best = nullptr;
  size_t best_len = 0;
  for (const char32_t* suf : sufs) {
    const size_t sl = u32_len(suf);
    if (sl > best_len && w.size() >= sl &&
        static_cast<int>(w.size() - sl) >= rv && u32_ends(w, suf)) {
      best = suf;
      best_len = sl;
    }
  }
  return best;
}

// longest across both groups; group-1 needs a preceding а/я in RV. Returns
// false when nothing was removed (a failed condition fails the category).
template <size_t N1, size_t N2>
inline bool ru_try_group12(u32& w, const char32_t* (&g1)[N1],
                           const char32_t* (&g2)[N2], int rv) {
  const char32_t* m1 = ru_longest(w, g1, rv);
  const char32_t* m2 = ru_longest(w, g2, rv);
  const size_t l1 = m1 ? u32_len(m1) : 0;
  const size_t l2 = m2 ? u32_len(m2) : 0;
  if (m2 != nullptr && l2 >= l1) {
    w.resize(w.size() - l2);
    return true;
  }
  if (m1 != nullptr) {
    const int pos = static_cast<int>(w.size() - l1);
    if (pos > 0 && pos - 1 >= rv && (w[pos - 1] == U'а' || w[pos - 1] == U'я')) {
      w.resize(pos);
      return true;
    }
  }
  return false;
}

void russian_stem(u32& w) {
  for (auto& c : w)
    if (c == U'ё') c = U'е';  // spec assumption
  const int n = static_cast<int>(w.size());
  int rv = n;
  for (int i = 0; i < n; ++i) {
    if (ru_vowel(w[i])) { rv = i + 1; break; }
  }
  auto next_region = [&](int start) {
    int i = start;
    while (i < n && !ru_vowel(w[i])) ++i;
    while (i < n && ru_vowel(w[i])) ++i;
    return i < n ? std::min(i + 1, n) : n;
  };
  const int r1 = next_region(0);
  const int r2 = next_region(r1);

  // step 1
  if (!ru_try_group12(w, kRuPerfGerund1, kRuPerfGerund2, rv)) {
    if (u32_ends(w, U"ся") && static_cast<int>(w.size()) - 2 >= rv)
      w.resize(w.size() - 2);
    else if (u32_ends(w, U"сь") && static_cast<int>(w.size()) - 2 >= rv)
      w.resize(w.size() - 2);
    const char32_t* adj = ru_longest(w, kRuAdjective, rv);
    if (adj != nullptr) {
      w.resize(w.size() - u32_len(adj));
      ru_try_group12(w, kRuParticiple1, kRuParticiple2, rv);
    } else if (!ru_try_group12(w, kRuVerb1, kRuVerb2, rv)) {
      const char32_t* noun = ru_longest(w, kRuNoun, rv);
      if (noun != nullptr) w.resize(w.size() - u32_len(noun));
    }
  }
  // step 2: final и
  if (u32_ends(w, U"и") && static_cast<int>(w.size()) - 1 >= rv)
    w.resize(w.size() - 1);
  // step 3: derivational (in R2)
  if (u32_ends(w, U"ость") && static_cast<int>(w.size()) - 4 >= r2)
    w.resize(w.size() - 4);
  else if (u32_ends(w, U"ост") && static_cast<int>(w.size()) - 3 >= r2)
    w.resize(w.size() - 3);
  // step 4: tidy up (нн matches entirely inside RV)
  if (u32_ends(w, U"нн") && static_cast<int>(w.size()) - 2 >= rv) {
    w.resize(w.size() - 1);
  } else {
    const char32_t* sup = nullptr;
    if (u32_ends(w, U"ейше") && static_cast<int>(w.size()) - 4 >= rv) sup = U"ейше";
    else if (u32_ends(w, U"ейш") && static_cast<int>(w.size()) - 3 >= rv) sup = U"ейш";
    if (sup != nullptr) {
      w.resize(w.size() - u32_len(sup));
      if (u32_ends(w, U"нн") && static_cast<int>(w.size()) - 2 >= rv)
        w.resize(w.size() - 1);
    } else if (u32_ends(w, U"ь") && static_cast<int>(w.size()) - 1 >= rv) {
      w.resize(w.size() - 1);
    }
  }
}

// -- Italian (Snowball italian stemmer; mirrors snowball.py italian_stem) ----

inline bool it_vowel(char32_t c) {
  return c == U'a' || c == U'e' || c == U'i' || c == U'o' || c == U'u' ||
         c == 0xE0 || c == 0xE8 || c == 0xEC || c == 0xF2 || c == 0xF9;  // à è ì ò ù
}

static const char32_t* kItPron[] = {
    U"gliela", U"gliele", U"glieli", U"glielo", U"gliene", U"sene",
    U"mela", U"mele", U"meli", U"melo", U"mene", U"tela", U"tele", U"teli",
    U"telo", U"tene", U"cela", U"cele", U"celi", U"celo", U"cene", U"vela",
    U"vele", U"veli", U"velo", U"vene", U"gli", U"ci", U"la", U"le", U"li",
    U"lo", U"mi", U"ne", U"si", U"ti", U"vi"};

struct ItRule { const char32_t* suf; int action; };
// actions: 0=del(r2) 1=del_r2+ic 2=log 3=u 4=ente 5=del(rv) 6=amente(r1)
//          7=ità 8=iv
static const ItRule kItStep1[] = {
    {U"atrice", 0}, {U"atrici", 0}, {U"anza", 0}, {U"anze", 0}, {U"iche", 0},
    {U"ichi", 0}, {U"ismo", 0}, {U"ismi", 0}, {U"abile", 0}, {U"abili", 0},
    {U"ibile", 0}, {U"ibili", 0}, {U"ista", 0}, {U"iste", 0}, {U"isti", 0},
    {U"istà", 0}, {U"istè", 0}, {U"istì", 0}, {U"mente", 0}, {U"ante", 0},
    {U"anti", 0}, {U"oso", 0}, {U"osi", 0}, {U"osa", 0}, {U"ose", 0},
    {U"ico", 0}, {U"ici", 0}, {U"ica", 0}, {U"ice", 0},
    {U"azione", 1}, {U"azioni", 1}, {U"atore", 1}, {U"atori", 1},
    {U"logia", 2}, {U"logie", 2},
    {U"uzione", 3}, {U"uzioni", 3}, {U"usione", 3}, {U"usioni", 3},
    {U"enza", 4}, {U"enze", 4},
    {U"amento", 5}, {U"amenti", 5}, {U"imento", 5}, {U"imenti", 5},
    {U"amente", 6}, {U"ità", 7},
    {U"ivo", 8}, {U"ivi", 8}, {U"iva", 8}, {U"ive", 8},
};
static const char32_t* kItStep2[] = {
    U"erebbero", U"irebbero", U"assero", U"assimo", U"eranno", U"erebbe",
    U"eremmo", U"ereste", U"eresti", U"essero", U"iranno", U"irebbe",
    U"iremmo", U"ireste", U"iresti", U"iscano", U"iscono", U"issero",
    U"arono", U"avamo", U"avano", U"avate", U"eremo", U"erete", U"erono",
    U"evamo", U"evano", U"evate", U"iremo", U"irete", U"irono", U"ivamo",
    U"ivano", U"ivate", U"ammo", U"ando", U"asse", U"assi", U"emmo",
    U"enda", U"ende", U"endi", U"endo", U"erai", U"erei", U"Yamo", U"iamo",
    U"immo", U"irai", U"irei", U"isca", U"isce", U"isci", U"isco", U"ano",
    U"are", U"ata", U"ate", U"ati", U"ato", U"ava", U"avi", U"avo",
    U"erà", U"ere", U"erò", U"ete", U"eva", U"evi", U"evo", U"irà",
    U"ire", U"irò", U"ita", U"ite", U"iti", U"ito", U"iva", U"ivi",
    U"ivo", U"ono", U"uta", U"ute", U"uti", U"uto", U"ar", U"ir"};

inline int it_rv(const u32& w) {
  const int n = static_cast<int>(w.size());
  if (n < 3) return n;
  if (!it_vowel(w[1])) {
    int i = 2;
    while (i < n && !it_vowel(w[i])) ++i;
    return std::min(i + 1, n);
  }
  if (it_vowel(w[0]) && it_vowel(w[1])) {
    int i = 2;
    while (i < n && it_vowel(w[i])) ++i;
    return std::min(i + 1, n);
  }
  return 3;
}

inline void it_regions(const u32& w, int* r1, int* r2) {
  const int n = static_cast<int>(w.size());
  auto next_region = [&](int start) {
    int i = start;
    while (i < n && !it_vowel(w[i])) ++i;
    while (i < n && it_vowel(w[i])) ++i;
    return i < n ? std::min(i + 1, n) : n;
  };
  *r1 = next_region(0);
  *r2 = next_region(*r1);
}

void italian_stem(u32& w) {
  // acute -> grave accents, then u/i marking
  for (auto& c : w) {
    if (c == 0xE1) c = 0xE0;
    else if (c == 0xE9) c = 0xE8;
    else if (c == 0xED) c = 0xEC;
    else if (c == 0xF3) c = 0xF2;
    else if (c == 0xFA) c = 0xF9;
  }
  {
    const int n = static_cast<int>(w.size());
    for (int i = 0; i < n; ++i) {
      const char32_t c = w[i];
      if (c == U'u' && i > 0 && w[i - 1] == U'q') w[i] = U'U';
      else if ((c == U'u' || c == U'i') && i > 0 && i < n - 1 &&
               it_vowel(w[i - 1]) && it_vowel(w[i + 1]))
        w[i] = (c == U'u') ? U'U' : U'I';
    }
  }
  const int rv = it_rv(w);
  int r1, r2;
  it_regions(w, &r1, &r2);
  auto in_rv = [&](int pos) { return pos >= rv; };
  auto in_r1 = [&](int pos) { return pos >= r1; };
  auto in_r2 = [&](int pos) { return pos >= r2; };

  // step 0: attached pronoun
  {
    const char32_t* bp = nullptr;
    size_t bl = 0;
    for (const char32_t* pron : kItPron) {
      const size_t sl = u32_len(pron);
      if (sl > bl && u32_ends(w, pron)) { bp = pron; bl = sl; }
    }
    if (bp != nullptr && w.size() > bl) {
      u32 base = w.substr(0, w.size() - bl);
      if ((u32_ends(base, U"ando") || u32_ends(base, U"endo")) &&
          in_rv(static_cast<int>(base.size()) - 4)) {
        w = base;
      } else if ((u32_ends(base, U"ar") || u32_ends(base, U"er") ||
                  u32_ends(base, U"ir")) &&
                 in_rv(static_cast<int>(base.size()) - 2)) {
        w = base;
        w.push_back(U'e');
      }
    }
  }

  const size_t n0 = w.size();
  // step 1: standard suffixes, longest match
  const ItRule* best = nullptr;
  size_t best_len = 0;
  for (const auto& r : kItStep1) {
    const size_t sl = u32_len(r.suf);
    if (sl > best_len && u32_ends(w, r.suf)) { best = &r; best_len = sl; }
  }
  if (best != nullptr) {
    const int pos = static_cast<int>(w.size() - best_len);
    switch (best->action) {
      case 0:
        if (in_r2(pos)) w.resize(pos);
        break;
      case 1:
        if (in_r2(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"ic") && in_r2(static_cast<int>(w.size()) - 2))
            w.resize(w.size() - 2);
        }
        break;
      case 2:
        if (in_r2(pos)) { w.resize(pos); w.append(U"log"); }
        break;
      case 3:
        if (in_r2(pos)) { w.resize(pos); w.append(U"u"); }
        break;
      case 4:
        if (in_r2(pos)) { w.resize(pos); w.append(U"ente"); }
        break;
      case 5:
        if (in_rv(pos)) w.resize(pos);
        break;
      case 6:
        if (in_r1(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"iv") && in_r2(static_cast<int>(w.size()) - 2)) {
            w.resize(w.size() - 2);
            if (u32_ends(w, U"at") && in_r2(static_cast<int>(w.size()) - 2))
              w.resize(w.size() - 2);
          } else if (u32_ends(w, U"abil") && in_r2(static_cast<int>(w.size()) - 4)) {
            w.resize(w.size() - 4);
          } else if ((u32_ends(w, U"os") || u32_ends(w, U"ic")) &&
                     in_r2(static_cast<int>(w.size()) - 2)) {
            w.resize(w.size() - 2);
          }
        }
        break;
      case 7:
        if (in_r2(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"abil") && in_r2(static_cast<int>(w.size()) - 4))
            w.resize(w.size() - 4);
          else if ((u32_ends(w, U"ic") || u32_ends(w, U"iv")) &&
                   in_r2(static_cast<int>(w.size()) - 2))
            w.resize(w.size() - 2);
        }
        break;
      case 8:
        if (in_r2(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"at") && in_r2(static_cast<int>(w.size()) - 2)) {
            w.resize(w.size() - 2);
            if (u32_ends(w, U"ic") && in_r2(static_cast<int>(w.size()) - 2))
              w.resize(w.size() - 2);
          }
        }
        break;
    }
  }

  // step 2: verb suffixes (only if step 1 removed nothing)
  if (w.size() == n0) {
    const char32_t* m2 = nullptr;
    size_t ml = 0;
    for (const char32_t* suf : kItStep2) {
      const size_t sl = u32_len(suf);
      if (sl > ml && u32_ends(w, suf)) { m2 = suf; ml = sl; }
    }
    if (m2 != nullptr && in_rv(static_cast<int>(w.size() - ml))) {
      w.resize(w.size() - ml);
    }
  }

  // step 3a: final vowel (+ a preceding i), in RV
  if (!w.empty()) {
    const char32_t c = w.back();
    const bool fv = c == U'a' || c == U'e' || c == U'i' || c == U'o' ||
                    c == 0xE0 || c == 0xE8 || c == 0xEC || c == 0xF2;
    if (fv && in_rv(static_cast<int>(w.size()) - 1)) {
      w.resize(w.size() - 1);
      if (u32_ends(w, U"i") && in_rv(static_cast<int>(w.size()) - 1))
        w.resize(w.size() - 1);
    }
  }
  // step 3b: ch/gh -> c/g in RV
  if ((u32_ends(w, U"ch") || u32_ends(w, U"gh")) &&
      in_rv(static_cast<int>(w.size()) - 2))
    w.resize(w.size() - 1);

  for (auto& c : w) {
    if (c == U'I') c = U'i';
    else if (c == U'U') c = U'u';
  }
}

// -- Dutch (Snowball dutch stemmer; mirrors snowball.py dutch_stem) ----------

inline bool nl_vowel(char32_t c) {
  return c == U'a' || c == U'e' || c == U'i' || c == U'o' || c == U'u' ||
         c == U'y' || c == 0xE8;  // è
}

inline void nl_undouble(u32& w) {
  if (u32_ends(w, U"kk") || u32_ends(w, U"dd") || u32_ends(w, U"tt"))
    w.resize(w.size() - 1);
}

void dutch_stem(u32& w) {
  // umlauts/acutes -> plain vowels
  for (auto& c : w) {
    switch (c) {
      case 0xE4: case 0xE1: c = U'a'; break;
      case 0xEB: case 0xE9: c = U'e'; break;
      case 0xEF: case 0xED: c = U'i'; break;
      case 0xF6: case 0xF3: c = U'o'; break;
      case 0xFC: case 0xFA: c = U'u'; break;
      default: break;
    }
  }
  {  // initial y, y after a vowel, i between vowels -> markers
    const int n = static_cast<int>(w.size());
    for (int i = 0; i < n; ++i) {
      const char32_t c = w[i];
      if (c == U'y' && (i == 0 || nl_vowel(w[i - 1]))) w[i] = U'Y';
      else if (c == U'i' && i > 0 && i < n - 1 && nl_vowel(w[i - 1]) &&
               nl_vowel(w[i + 1]))
        w[i] = U'I';
    }
  }
  const int n = static_cast<int>(w.size());
  int r1, r2;
  {
    auto next_region = [&](int start) {
      int i = start;
      while (i < n && !nl_vowel(w[i])) ++i;
      while (i < n && nl_vowel(w[i])) ++i;
      return i < n ? std::min(i + 1, n) : n;
    };
    r1 = next_region(0);
    r2 = next_region(r1);
    if (r1 < 3) r1 = std::min(3, n);
  }
  auto in_r1 = [&](int pos) { return pos >= r1; };
  auto in_r2 = [&](int pos) { return pos >= r2; };

  // delete en/ene if in R1, preceded by a valid en-ending (non-vowel, not
  // gem); undouble. Returns whether a deletion happened.
  auto del_en = [&](u32& v) -> bool {
    const char32_t* sufs[] = {U"ene", U"en"};
    for (const char32_t* suf : sufs) {
      const size_t sl = u32_len(suf);
      if (v.size() >= sl && u32_ends(v, suf)) {
        const int pos = static_cast<int>(v.size() - sl);
        const bool gem = pos >= 3 && v[pos - 3] == U'g' && v[pos - 2] == U'e' &&
                         v[pos - 1] == U'm';
        if (in_r1(pos) && pos > 0 && !nl_vowel(v[pos - 1]) && !gem) {
          v.resize(pos);
          nl_undouble(v);
          return true;
        }
        return false;
      }
    }
    return false;
  };

  // step 1
  if (u32_ends(w, U"heden")) {
    if (in_r1(static_cast<int>(w.size()) - 5)) {
      w.resize(w.size() - 5);
      w.append(U"heid");
    }
  } else if (!del_en(w)) {
    const char32_t* suf = u32_ends(w, U"se") ? U"se"
                        : (u32_ends(w, U"s") ? U"s" : nullptr);
    if (suf != nullptr) {
      const int pos = static_cast<int>(w.size() - u32_len(suf));
      if (in_r1(pos) && pos > 0 && !nl_vowel(w[pos - 1]) && w[pos - 1] != U'j')
        w.resize(pos);
    }
  }

  // step 2: delete suffix e if in R1 and preceded by a non-vowel
  bool e_removed = false;
  if (u32_ends(w, U"e") && in_r1(static_cast<int>(w.size()) - 1) &&
      w.size() >= 2 && !nl_vowel(w[w.size() - 2])) {
    w.resize(w.size() - 1);
    nl_undouble(w);
    e_removed = true;
  }

  // step 3a: heid
  if (u32_ends(w, U"heid") && in_r2(static_cast<int>(w.size()) - 4) &&
      (w.size() < 5 || w[w.size() - 5] != U'c')) {
    w.resize(w.size() - 4);
    del_en(w);
  }

  // step 3b: d-suffixes (longest among)
  {
    const char32_t* m = nullptr;
    size_t ml = 0;
    for (const char32_t* suf :
         {U"lijk", U"baar", U"end", U"ing", U"bar", U"ig"}) {
      const size_t sl = u32_len(suf);
      if (sl > ml && u32_ends(w, suf)) { m = suf; ml = sl; }
    }
    if (m != nullptr) {
      const int pos = static_cast<int>(w.size() - ml);
      const bool is_end = std::char_traits<char32_t>::compare(m, U"end", 4) == 0;
      const bool is_ing = std::char_traits<char32_t>::compare(m, U"ing", 4) == 0;
      if (is_end || is_ing) {
        if (in_r2(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"ig") && in_r2(static_cast<int>(w.size()) - 2) &&
              (w.size() < 3 || w[w.size() - 3] != U'e')) {
            w.resize(w.size() - 2);
          } else {
            nl_undouble(w);
          }
        }
      } else if (ml == 2) {  // ig
        if (in_r2(pos) && (pos == 0 || w[pos - 1] != U'e')) w.resize(pos);
      } else if (std::char_traits<char32_t>::compare(m, U"lijk", 5) == 0) {
        if (in_r2(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"e") && in_r1(static_cast<int>(w.size()) - 1) &&
              w.size() >= 2 && !nl_vowel(w[w.size() - 2])) {
            w.resize(w.size() - 1);
            nl_undouble(w);
          }
        }
      } else if (std::char_traits<char32_t>::compare(m, U"baar", 5) == 0) {
        if (in_r2(pos)) w.resize(pos);
      } else {  // bar
        if (in_r2(pos) && e_removed) w.resize(pos);
      }
    }
  }

  // step 4: undouble vowel (C V V D; D a non-vowel other than I)
  if (w.size() >= 4) {
    const char32_t c = w[w.size() - 4], v1 = w[w.size() - 3],
                   v2 = w[w.size() - 2], d = w[w.size() - 1];
    const bool dbl = v1 == v2 && (v1 == U'a' || v1 == U'e' || v1 == U'o' ||
                                  v1 == U'u');
    if (!nl_vowel(c) && dbl && !nl_vowel(d) && d != U'I') {
      w[w.size() - 2] = d;
      w.resize(w.size() - 1);
    }
  }

  for (auto& c : w) {
    if (c == U'I') c = U'i';
    else if (c == U'Y') c = U'y';
  }
}

// -- Portuguese (Snowball; mirrors snowball.py portuguese_stem) --------------

inline bool pt_vowel(char32_t c) {
  return c == U'a' || c == U'e' || c == U'i' || c == U'o' || c == U'u' ||
         c == 0xE1 || c == 0xE9 || c == 0xED || c == 0xF3 || c == 0xFA ||
         c == 0xE2 || c == 0xEA || c == 0xF4;  // á é í ó ú â ê ô
}

struct PtRule { const char32_t* suf; int action; };
// actions: 0=del(r2) 1=log 2=u 3=ente 4=amente(r1) 5=mente 6=idade 7=iv 8=eira
static const PtRule kPtStep1[] = {
    {U"amentos", 0}, {U"imentos", 0}, {U"amento", 0}, {U"imento", 0},
    {U"adoras", 0}, {U"adores", 0}, {U"ações", 0}, {U"ância", 0},
    {U"antes", 0}, {U"adora", 0}, {U"ação", 0}, {U"ador", 0}, {U"ante", 0},
    {U"ezas", 0}, {U"icos", 0}, {U"icas", 0}, {U"ismos", 0}, {U"ável", 0},
    {U"ível", 0}, {U"istas", 0}, {U"osos", 0}, {U"osas", 0}, {U"eza", 0},
    {U"ico", 0}, {U"ica", 0}, {U"ismo", 0}, {U"ista", 0}, {U"oso", 0},
    {U"osa", 0},
    {U"logias", 1}, {U"logia", 1},
    {U"uções", 2}, {U"ução", 2},
    {U"ências", 3}, {U"ência", 3},
    {U"amente", 4}, {U"mente", 5},
    {U"idades", 6}, {U"idade", 6},
    {U"ivas", 7}, {U"ivos", 7}, {U"iva", 7}, {U"ivo", 7},
    {U"iras", 8}, {U"ira", 8},
};
// full regular -ar/-er/-ir paradigm, longest-first (see snowball.py note)
static const char32_t* kPtStep2[] = {
    U"aríamos", U"eríamos", U"iríamos", U"ássemos", U"êssemos", U"íssemos",
    U"ávamos", U"áramos", U"éramos", U"íramos", U"aremos", U"eremos",
    U"iremos", U"ariam", U"eriam", U"iriam", U"aríeis", U"eríeis",
    U"iríeis", U"ásseis", U"ésseis", U"ísseis", U"astes", U"estes",
    U"istes", U"assem", U"essem", U"issem", U"asses", U"esses", U"isses",
    U"áveis", U"áreis", U"éreis", U"íreis", U"arias", U"erias", U"irias",
    U"ardes", U"erdes", U"irdes", U"armos", U"ermos", U"irmos", U"aria",
    U"eria", U"iria", U"asse", U"esse", U"isse", U"aste", U"este",
    U"iste", U"arei", U"erei", U"irei", U"arás", U"erás", U"irás",
    U"arão", U"erão", U"irão", U"ando", U"endo",
    U"indo", U"adas", U"idas", U"ados", U"idos", U"aram",
    U"eram", U"iram", U"avam", U"arem", U"erem", U"irem", U"amos",
    U"emos", U"imos", U"íamos", U"ara", U"aras", U"era", U"eras", U"ira",
    U"iras", U"avas", U"ares", U"eres", U"ires", U"íeis", U"ado",
    U"ada", U"ido", U"ida", U"ará", U"erá", U"irá", U"ava", U"iam",
    U"ias", U"ais", U"eis", U"ei", U"ou", U"eu", U"iu", U"am", U"em",
    U"ar", U"er", U"ir", U"as", U"es", U"is", U"ia",
};

inline int pt_rv(const u32& w) {
  const int n = static_cast<int>(w.size());
  if (n < 3) return n;
  if (!pt_vowel(w[1])) {
    int i = 2;
    while (i < n && !pt_vowel(w[i])) ++i;
    return std::min(i + 1, n);
  }
  if (pt_vowel(w[0]) && pt_vowel(w[1])) {
    int i = 2;
    while (i < n && pt_vowel(w[i])) ++i;
    return std::min(i + 1, n);
  }
  return 3;
}

inline void pt_regions(const u32& w, int* r1, int* r2) {
  const int n = static_cast<int>(w.size());
  auto next_region = [&](int start) {
    int i = start;
    while (i < n && !pt_vowel(w[i])) ++i;
    while (i < n && pt_vowel(w[i])) ++i;
    return i < n ? std::min(i + 1, n) : n;
  };
  *r1 = next_region(0);
  *r2 = next_region(*r1);
}

void portuguese_stem(u32& w) {
  const int rv = pt_rv(w);
  int r1, r2;
  pt_regions(w, &r1, &r2);
  auto in_rv = [&](int pos) { return pos >= rv; };
  auto in_r1 = [&](int pos) { return pos >= r1; };
  auto in_r2 = [&](int pos) { return pos >= r2; };

  const size_t n0 = w.size();
  // step 1
  const PtRule* best = nullptr;
  size_t best_len = 0;
  for (const auto& r : kPtStep1) {
    const size_t sl = u32_len(r.suf);
    if (sl > best_len && u32_ends(w, r.suf)) { best = &r; best_len = sl; }
  }
  if (best != nullptr) {
    const int pos = static_cast<int>(w.size() - best_len);
    switch (best->action) {
      case 0:
        if (in_r2(pos)) w.resize(pos);
        break;
      case 1:
        if (in_r2(pos)) { w.resize(pos); w.append(U"log"); }
        break;
      case 2:
        if (in_r2(pos)) { w.resize(pos); w.append(U"u"); }
        break;
      case 3:
        if (in_r2(pos)) { w.resize(pos); w.append(U"ente"); }
        break;
      case 4:
        if (in_r1(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"iv") && in_r2(static_cast<int>(w.size()) - 2)) {
            w.resize(w.size() - 2);
            if (u32_ends(w, U"at") && in_r2(static_cast<int>(w.size()) - 2))
              w.resize(w.size() - 2);
          } else if ((u32_ends(w, U"os") || u32_ends(w, U"ic") ||
                      u32_ends(w, U"ad")) &&
                     in_r2(static_cast<int>(w.size()) - 2)) {
            w.resize(w.size() - 2);
          }
        }
        break;
      case 5:
        if (in_r2(pos)) {
          w.resize(pos);
          const char32_t* pres[] = {U"ante", U"avel", U"ível"};
          for (const char32_t* pre : pres) {
            if (u32_ends(w, pre) && in_r2(static_cast<int>(w.size()) - 4)) {
              w.resize(w.size() - 4);
              break;
            }
          }
        }
        break;
      case 6:
        if (in_r2(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"abil") && in_r2(static_cast<int>(w.size()) - 4))
            w.resize(w.size() - 4);
          else if ((u32_ends(w, U"ic") || u32_ends(w, U"iv")) &&
                   in_r2(static_cast<int>(w.size()) - 2))
            w.resize(w.size() - 2);
        }
        break;
      case 7:
        if (in_r2(pos)) {
          w.resize(pos);
          if (u32_ends(w, U"at") && in_r2(static_cast<int>(w.size()) - 2))
            w.resize(w.size() - 2);
        }
        break;
      case 8:
        if (in_rv(pos) && pos > 0 && w[pos - 1] == U'e') {
          w.resize(pos);
          w.append(U"ir");
        }
        break;
    }
  }

  // step 2 (only if step 1 removed nothing): longest match
  bool step2_done = false;
  if (w.size() == n0) {
    const char32_t* m2 = nullptr;
    size_t ml = 0;
    for (const char32_t* suf : kPtStep2) {
      if (suf == nullptr) continue;
      const size_t sl = u32_len(suf);
      if (sl > ml && u32_ends(w, suf)) { m2 = suf; ml = sl; }
    }
    if (m2 != nullptr && in_rv(static_cast<int>(w.size() - ml))) {
      w.resize(w.size() - ml);
      step2_done = true;
    }
  }

  if (w.size() != n0 || step2_done) {
    // step 3: delete i if in RV and preceded by c
    if (u32_ends(w, U"i") && in_rv(static_cast<int>(w.size()) - 1) &&
        w.size() >= 2 && w[w.size() - 2] == U'c')
      w.resize(w.size() - 1);
  } else {
    // step 4: residual suffix
    const char32_t* m4 = nullptr;
    size_t ml = 0;
    for (const char32_t* suf : {U"os", U"a", U"i", U"o", U"á", U"í", U"ó"}) {
      const size_t sl = u32_len(suf);
      if (sl > ml && u32_ends(w, suf)) { m4 = suf; ml = sl; }
    }
    if (m4 != nullptr && in_rv(static_cast<int>(w.size() - ml)))
      w.resize(w.size() - ml);
  }

  // step 5: final e/é/ê in RV (+ gu/ci), or ç -> c
  if (!w.empty() &&
      (w.back() == U'e' || w.back() == 0xE9 || w.back() == 0xEA) &&
      in_rv(static_cast<int>(w.size()) - 1)) {
    w.resize(w.size() - 1);
    if (u32_ends(w, U"gu") && in_rv(static_cast<int>(w.size()) - 1))
      w.resize(w.size() - 1);
    else if (u32_ends(w, U"ci") && in_rv(static_cast<int>(w.size()) - 1))
      w.resize(w.size() - 1);
  } else if (!w.empty() && w.back() == 0xE7) {
    w.back() = U'c';
  }

  // de-accent
  for (auto& c : w) {
    switch (c) {
      case 0xE1: case 0xE2: c = U'a'; break;
      case 0xE9: case 0xEA: c = U'e'; break;
      case 0xED: c = U'i'; break;
      case 0xF3: case 0xF4: c = U'o'; break;
      case 0xFA: c = U'u'; break;
      default: break;
    }
  }
}

// -- Swedish / Norwegian / Danish (Snowball; mirror snowball.py) -------------

// R1 with the Scandinavian min-3 adjustment
template <typename VowelFn>
inline int scan_r1(const u32& w, VowelFn vowel) {
  const int n = static_cast<int>(w.size());
  int i = 0;
  while (i < n && !vowel(w[i])) ++i;
  while (i < n && vowel(w[i])) ++i;
  int r1 = i < n ? std::min(i + 1, n) : n;
  if (r1 < 3) r1 = std::min(3, n);
  return r1;
}

inline bool sv_vowel(char32_t c) {
  return c == U'a' || c == U'e' || c == U'i' || c == U'o' || c == U'u' ||
         c == U'y' || c == 0xE4 || c == 0xE5 || c == 0xF6;  // ä å ö
}
inline bool scan_vowel_no_da(char32_t c) {
  return c == U'a' || c == U'e' || c == U'i' || c == U'o' || c == U'u' ||
         c == U'y' || c == 0xE6 || c == 0xE5 || c == 0xF8;  // æ å ø
}

// longest-first lists (mirror the python tuples)
static const char32_t* kSvStep1[] = {
    U"heterna", U"hetens", U"arnas", U"ernas", U"ornas", U"anden", U"heten",
    U"heter", U"andet", U"arens", U"andes", U"arna", U"erna", U"orna",
    U"ande", U"arne", U"aste", U"aren", U"ades", U"erns", U"ade", U"are",
    U"ern", U"ens", U"het", U"ast", U"ad", U"en", U"ar", U"er", U"or",
    U"as", U"es", U"at", U"a", U"e"};
static const char32_t* kNoStep1[] = {
    U"hetenes", U"hetene", U"hetens", U"heten", U"heter", U"endes",
    U"edes", U"enes", U"ande", U"ende", U"ane", U"ene", U"ede", U"ens",
    U"ers", U"ets", U"het", U"ast", U"en", U"ar", U"er", U"as", U"es",
    U"et", U"a", U"e"};
static const char32_t* kDaStep1[] = {
    U"erendes", U"erende", U"hedens", U"ethed", U"erede", U"heden",
    U"heder", U"erens", U"endes", U"ernes", U"erets", U"ered", U"ende",
    U"erne", U"eren", U"erer", U"heds", U"enes", U"eres", U"eret",
    U"hed", U"ene", U"ere", U"ens", U"ers", U"ets", U"es", U"en", U"er",
    U"et", U"e"};

inline bool ends_pair(const u32& w, const char* pairs[], int n_pairs, int r1) {
  if (w.size() < 2 || static_cast<int>(w.size()) - 2 < r1) return false;
  const char32_t a = w[w.size() - 2], b = w[w.size() - 1];
  for (int i = 0; i < n_pairs; ++i) {
    if (a == static_cast<char32_t>(pairs[i][0]) &&
        b == static_cast<char32_t>(pairs[i][1]))
      return true;
  }
  return false;
}

void swedish_stem(u32& w) {
  const int r1 = scan_r1(w, sv_vowel);
  // step 1
  const char32_t* m = nullptr;
  for (const char32_t* suf : kSvStep1) {
    if (u32_ends(w, suf)) { m = suf; break; }
  }
  if (m != nullptr) {
    const int pos = static_cast<int>(w.size() - u32_len(m));
    if (pos >= r1) w.resize(pos);
  } else if (u32_ends(w, U"s") && static_cast<int>(w.size()) - 1 >= r1 &&
             w.size() >= 2) {
    const char32_t p = w[w.size() - 2];
    static const char32_t kSEnd[] = U"bcdfghjklmnoprtvy";
    for (const char32_t* c = kSEnd; *c; ++c) {
      if (p == *c) { w.resize(w.size() - 1); break; }
    }
  }
  // step 2
  static const char* kPairs[] = {"dd", "gd", "nn", "dt", "gt", "kt", "tt"};
  if (ends_pair(w, kPairs, 7, r1)) w.resize(w.size() - 1);
  // step 3
  bool done = false;
  for (const char32_t* suf : {U"lig", U"els", U"ig"}) {
    const size_t sl = u32_len(suf);
    if (u32_ends(w, suf) && static_cast<int>(w.size() - sl) >= r1) {
      w.resize(w.size() - sl);
      done = true;
      break;
    }
  }
  if (!done) {
    if (u32_ends(w, U"löst") && static_cast<int>(w.size()) - 4 >= r1)
      w.resize(w.size() - 1);
    else if (u32_ends(w, U"fullt") && static_cast<int>(w.size()) - 5 >= r1)
      w.resize(w.size() - 1);
  }
}

void norwegian_stem(u32& w) {
  const int r1 = scan_r1(w, scan_vowel_no_da);
  // step 1: longest among {list(del), erte/ert(->er), s(cond)}
  const char32_t* best = nullptr;
  int act = -1;  // 0=del 1=er 2=s
  size_t bl = 0;
  for (const char32_t* suf : kNoStep1) {
    if (u32_ends(w, suf)) {
      best = suf; act = 0; bl = u32_len(suf);
      break;
    }
  }
  for (const char32_t* suf : {U"erte", U"ert"}) {
    const size_t sl = u32_len(suf);
    if (sl >= bl && u32_ends(w, suf)) { best = suf; act = 1; bl = sl; break; }
  }
  if (bl == 0 && u32_ends(w, U"s")) { best = U"s"; act = 2; bl = 1; }
  if (best != nullptr) {
    const int pos = static_cast<int>(w.size() - bl);
    if (act == 0) {
      if (pos >= r1) w.resize(pos);
    } else if (act == 1) {
      if (pos >= r1) { w.resize(pos); w.append(U"er"); }
    } else if (pos >= r1 && w.size() >= 2) {
      const char32_t p = w[w.size() - 2];
      static const char32_t kSEnd[] = U"bcdfghjlmnoprtvyz";
      bool ok = false;
      for (const char32_t* c = kSEnd; *c; ++c)
        if (p == *c) { ok = true; break; }
      if (!ok && p == U'k' &&
          (w.size() < 3 || !scan_vowel_no_da(w[w.size() - 3])))
        ok = true;
      if (ok) w.resize(w.size() - 1);
    }
  }
  // step 2
  static const char* kPairs[] = {"dt", "vt"};
  if (ends_pair(w, kPairs, 2, r1)) w.resize(w.size() - 1);
  // step 3
  for (const char32_t* suf : {U"hetslov", U"slov", U"elov", U"elig", U"eleg",
                              U"lov", U"lig", U"eig", U"leg", U"els", U"ig"}) {
    const size_t sl = u32_len(suf);
    if (u32_ends(w, suf) && static_cast<int>(w.size() - sl) >= r1) {
      w.resize(w.size() - sl);
      break;
    }
  }
}

void danish_stem(u32& w) {
  const int r1 = scan_r1(w, scan_vowel_no_da);
  static const char* kPairs[] = {"gd", "dt", "gt", "kt"};
  auto step2 = [&]() {
    if (ends_pair(w, kPairs, 4, r1)) w.resize(w.size() - 1);
  };
  // step 1
  const char32_t* m = nullptr;
  for (const char32_t* suf : kDaStep1) {
    if (u32_ends(w, suf)) { m = suf; break; }
  }
  if (m != nullptr) {
    const int pos = static_cast<int>(w.size() - u32_len(m));
    if (pos >= r1) w.resize(pos);
  } else if (u32_ends(w, U"s") && static_cast<int>(w.size()) - 1 >= r1 &&
             w.size() >= 2) {
    const char32_t p = w[w.size() - 2];
    static const char32_t kSEnd[] = U"abcdfghjklmnoprtvyzå";
    for (const char32_t* c = kSEnd; *c; ++c) {
      if (p == *c) { w.resize(w.size() - 1); break; }
    }
  }
  // step 2
  step2();
  // step 3
  if (u32_ends(w, U"igst") && static_cast<int>(w.size()) - 2 >= r1)
    w.resize(w.size() - 2);
  const char32_t* m3 = nullptr;
  for (const char32_t* suf : {U"elig", U"lig", U"els", U"ig"}) {
    if (u32_ends(w, suf)) { m3 = suf; break; }
  }
  if (m3 != nullptr &&
      static_cast<int>(w.size() - u32_len(m3)) >= r1) {
    w.resize(w.size() - u32_len(m3));
    step2();
  } else if (u32_ends(w, U"løst") && static_cast<int>(w.size()) - 4 >= r1) {
    w.resize(w.size() - 1);
  }
  // step 4: undouble (last letter in R1)
  if (w.size() >= 2 && w[w.size() - 1] == w[w.size() - 2] &&
      !scan_vowel_no_da(w[w.size() - 1]) &&
      static_cast<int>(w.size()) - 1 >= r1)
    w.resize(w.size() - 1);
}

// lang codes (mirror snowball.py STEMMED_LANGUAGES):
// 0=none 1=english 2=german 3=spanish 4=french 5=russian 6=italian 7=dutch
// 8=portuguese 9=swedish 10=norwegian 11=danish
inline void stem_token_lang(std::string& token, int lang) {
  if (lang == 1) {
    if (is_ascii(token)) porter_stem(token);
    return;
  }
  if (lang >= 2 && lang <= 11) {
    u32 w = utf8_decode(token);
    if (lang == 2) german_stem(w);
    else if (lang == 3) spanish_stem(w);
    else if (lang == 4) french_stem(w);
    else if (lang == 5) russian_stem(w);
    else if (lang == 6) italian_stem(w);
    else if (lang == 7) dutch_stem(w);
    else if (lang == 8) portuguese_stem(w);
    else if (lang == 9) swedish_stem(w);
    else if (lang == 10) norwegian_stem(w);
    else danish_stem(w);
    utf8_encode(w, token);
  }
}

}  // namespace

extern "C" {

// Tokenize one UTF-8 text: lowercase ASCII letters/digits, split on everything
// else, drop tokens shorter than min_len CODEPOINTS (not bytes — parity with
// the Python fallback's len(str)) and (optionally) stopwords, optionally
// Porter-stem ASCII tokens (ES language-analyzer parity), hash each token
// into [0, vocab_size) with FNV-1a (vocab_size must be a power of two).
// Callers must pre-lowercase non-ASCII text host-side (loader.py does) so
// native and fallback paths hash identical ids.
// Writes up to max_terms ids into out_ids; returns the number written.
int analyze_text_impl(const char* text, int32_t* out_ids, int max_terms,
                      int vocab_size, int min_len, int use_stopwords,
                      int use_stemmer,
                      const std::unordered_set<std::string>* extra_stops) {
  if (text == nullptr || max_terms <= 0) return 0;
  const uint64_t mask = static_cast<uint64_t>(vocab_size - 1);
  int count = 0;
  int token_cp = 0;  // codepoints in the current token
  std::string token;
  token.reserve(32);
  for (const char* p = text;; ++p) {
    const char c = *p;
    const bool alnum = (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
                       (c >= '0' && c <= '9') ||
                       static_cast<unsigned char>(c) >= 0x80;  // keep utf8 bytes
    if (alnum) {
      // UTF-8 continuation bytes (10xxxxxx) don't start a codepoint
      if ((static_cast<unsigned char>(c) & 0xC0) != 0x80) ++token_cp;
      token.push_back((c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c);
    } else {
      if (token_cp >= min_len &&
          (!use_stopwords || stopwords().count(token) == 0) &&
          (extra_stops == nullptr || extra_stops->count(token) == 0)) {
        // stem AFTER the stopword check (ES pipeline order: stop -> stem).
        // use_stemmer is a language code: 0=none 1=english 2=german 3=spanish
        if (use_stemmer) stem_token_lang(token, use_stemmer);
        out_ids[count++] = static_cast<int32_t>(fnv1a(token.data(), token.size()) & mask);
        if (count >= max_terms) return count;
      }
      token.clear();
      token_cp = 0;
      if (c == '\0') break;
    }
    if (c == '\0') break;
  }
  return count;
}

int analyze_text(const char* text, int32_t* out_ids, int max_terms,
                 int vocab_size, int min_len, int use_stopwords, int use_stemmer) {
  return analyze_text_impl(text, out_ids, max_terms, vocab_size, min_len,
                           use_stopwords, use_stemmer, nullptr);
}

// Batched analysis: `texts` are n zero-terminated strings concatenated;
// `offsets[i]` is the byte offset of text i (offsets[n] = total length).
// Output layout: out_ids is [n, max_terms]; out_counts[i] = #terms of text i.
// `extra_stops`: optional language stopword list (n_extra zero-terminated
// lowercase UTF-8 tokens concatenated), filtered BEFORE stemming — the ES
// pipeline order (stop -> stem) that a post-hoc hashed-id filter cannot
// reproduce once stemming rewrites the surface forms.
void analyze_batch(const char* texts, const int64_t* offsets, int n,
                   int32_t* out_ids, int32_t* out_counts, int max_terms,
                   int vocab_size, int min_len, int use_stopwords, int use_stemmer,
                   const char* extra_stops, int n_extra) {
  std::unordered_set<std::string> extra;
  if (extra_stops != nullptr && n_extra > 0) {
    const char* p = extra_stops;
    for (int i = 0; i < n_extra; ++i) {
      const size_t len = std::strlen(p);
      extra.emplace(p, len);
      p += len + 1;
    }
  }
  const std::unordered_set<std::string>* extra_ptr = extra.empty() ? nullptr : &extra;
  for (int i = 0; i < n; ++i) {
    out_counts[i] = analyze_text_impl(
        texts + offsets[i], out_ids + static_cast<int64_t>(i) * max_terms,
        max_terms, vocab_size, min_len, use_stopwords, use_stemmer, extra_ptr);
  }
}

// Stem one lowercase ASCII token in place (parity testing hook for porter.py).
// Returns the stemmed length; buf must hold at least the input length.
int porter_stem_token(char* buf, int len) {
  std::string w(buf, static_cast<size_t>(len));
  porter_stem(w);
  std::memcpy(buf, w.data(), w.size());
  return static_cast<int>(w.size());
}

// Stem one lowercase UTF-8 token in place by language code (parity testing
// hook for snowball.py; 1=english 2=german 3=spanish). Output bytes never
// exceed input bytes (ss replaces the 2-byte ß; accents only shrink), so buf
// holding the input length suffices. Returns the stemmed byte length.
int snowball_stem_token(char* buf, int len, int lang) {
  std::string w(buf, static_cast<size_t>(len));
  stem_token_lang(w, lang);
  std::memcpy(buf, w.data(), w.size());
  return static_cast<int>(w.size());
}

// Build impact-ordered truncated BM25 postings.
//   term_ids [total]  : concatenated per-doc term ids
//   doc_offsets [n+1] : CSR offsets into term_ids
//   out_docs  [n_terms, max_postings] (pre-filled with -1)
//   out_imps  [n_terms, max_postings] (pre-filled with 0)
// BM25: idf = ln(1 + (N - df + .5)/(df + .5)); impact = idf*tf*(k1+1)/(tf + k1*(1-b+b*dl/avgdl))
void build_postings(const int32_t* term_ids, const int64_t* doc_offsets, int n_docs,
                    int n_terms, int max_postings, float k1, float b,
                    int32_t* out_docs, float* out_imps) {
  // document lengths + average
  double total_len = 0;
  std::vector<int32_t> doc_len(n_docs);
  for (int d = 0; d < n_docs; ++d) {
    doc_len[d] = static_cast<int32_t>(doc_offsets[d + 1] - doc_offsets[d]);
    total_len += doc_len[d];
  }
  const double avgdl = n_docs > 0 ? std::max(total_len / n_docs, 1.0) : 1.0;

  // postings as per-term vectors of (doc, tf)
  std::vector<std::vector<std::pair<int32_t, int32_t>>> postings(n_terms);
  {
    std::unordered_map<int32_t, int32_t> tf;
    for (int d = 0; d < n_docs; ++d) {
      tf.clear();
      for (int64_t j = doc_offsets[d]; j < doc_offsets[d + 1]; ++j) {
        const int32_t t = term_ids[j];
        if (t >= 0 && t < n_terms) ++tf[t];
      }
      for (const auto& kv : tf) {
        postings[kv.first].emplace_back(d, kv.second);
      }
    }
  }

  std::vector<std::pair<float, int32_t>> scored;
  for (int t = 0; t < n_terms; ++t) {
    auto& plist = postings[t];
    if (plist.empty()) continue;
    const double df = static_cast<double>(plist.size());
    const double idf = std::log(1.0 + (n_docs - df + 0.5) / (df + 0.5));
    scored.clear();
    scored.reserve(plist.size());
    for (const auto& dt : plist) {
      const double tf = dt.second;
      const double norm = tf + k1 * (1.0 - b + b * doc_len[dt.first] / avgdl);
      scored.emplace_back(static_cast<float>(idf * tf * (k1 + 1.0) / norm), dt.first);
    }
    const int keep = std::min<int>(max_postings, static_cast<int>(scored.size()));
    std::partial_sort(scored.begin(), scored.begin() + keep, scored.end(),
                      [](const auto& a, const auto& b2) { return a.first > b2.first; });
    int32_t* docs_row = out_docs + static_cast<int64_t>(t) * max_postings;
    float* imps_row = out_imps + static_cast<int64_t>(t) * max_postings;
    for (int j = 0; j < keep; ++j) {
      docs_row[j] = scored[j].second;
      imps_row[j] = scored[j].first;
    }
  }
}

}  // extern "C"

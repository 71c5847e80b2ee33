"""Per-language stopword lists for the analyzer.

The port's copy of `vod_tpu/native/stopwords.py`, which it does not import; the
copy matches its reference token for token, faults included.

Parity: reference `vod_configs/utils/es_body.py` — the `__auto_stopwords__`
language patching (`validate_es_body:101`) over ES's 33-language map (`:32`,
`LANGUAGES_MAP`). The native analyzer filters English stopwords in C++; other
languages filter post-hoc by hashing the list with the same FNV function
(exact, since stopwords hash deterministically into the same id space).

Note on ja/zh/th: ES routes those through segmenting analyzers (cjk/thai);
this hash analyzer splits on codepoint runs, so the lists below catch the
particles that do surface as standalone tokens (space/punct-delimited text).
"""

from __future__ import annotations

# ISO 639-1 code -> analyzer language (parity: `es_body.py:32` LANGUAGES_MAP)
LANGUAGES_MAP: dict[str, str] = {
    "en": "english", "de": "german", "fr": "french", "es": "spanish",
    "it": "italian", "pt": "portuguese", "ru": "russian", "ja": "japanese",
    "zh": "chinese", "ar": "arabic", "da": "danish", "nl": "dutch",
    "fi": "finnish", "hu": "hungarian", "no": "norwegian", "ro": "romanian",
    "sv": "swedish", "tr": "turkish", "id": "indonesian", "ms": "malay",
    "vi": "vietnamese", "th": "thai", "cs": "czech", "el": "greek",
    "is": "icelandic", "pl": "polish", "sk": "slovak", "sl": "slovenian",
    "et": "estonian", "lv": "latvian", "lt": "lithuanian",
}


def normalize_language(language: str) -> str:
    """ISO code or name -> analyzer language (parity: `_normalize_language`)."""
    language = language.lower()
    return LANGUAGES_MAP.get(language, language)


STOPWORDS: dict[str, list[str]] = {
    "english": [
        "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
        "in", "into", "is", "it", "no", "not", "of", "on", "or", "such",
        "that", "the", "their", "then", "there", "these", "they", "this",
        "to", "was", "will", "with",
    ],
    "french": [
        "au", "aux", "avec", "ce", "ces", "dans", "de", "des", "du", "elle",
        "en", "et", "eux", "il", "je", "la", "le", "les", "leur", "lui",
        "ma", "mais", "me", "meme", "mes", "moi", "mon", "ne", "nos",
        "notre", "nous", "on", "ou", "par", "pas", "pour", "qu", "que",
        "qui", "sa", "se", "ses", "son", "sur", "ta", "te", "tes", "toi",
        "ton", "tu", "un", "une", "vos", "votre", "vous",
    ],
    "german": [
        "aber", "alle", "als", "also", "am", "an", "auch", "auf", "aus",
        "bei", "bin", "bis", "da", "das", "dass", "dem", "den", "der",
        "des", "die", "doch", "dort", "durch", "ein", "eine", "einem",
        "einen", "einer", "eines", "er", "es", "fur", "hat", "im", "in",
        "ist", "ja", "kann", "mit", "nach", "nicht", "noch", "nur", "oder",
        "sich", "sie", "sind", "so", "uber", "um", "und", "von", "vor",
        "war", "was", "wie", "wir", "zu", "zum", "zur",
    ],
    "spanish": [
        "al", "como", "con", "de", "del", "el", "ella", "en", "entre",
        "era", "es", "esta", "este", "fue", "ha", "la", "las", "le", "lo",
        "los", "mas", "muy", "no", "o", "para", "pero", "por", "que", "se",
        "si", "sin", "sobre", "su", "sus", "un", "una", "uno", "y", "ya",
    ],
    "italian": [
        "a", "al", "alla", "che", "chi", "ci", "come", "con", "da", "dei",
        "del", "della", "di", "e", "gli", "ha", "il", "in", "la", "le",
        "lo", "ma", "ne", "nel", "non", "per", "piu", "se", "si", "sono",
        "su", "un", "una", "uno",
    ],
    "portuguese": [
        "a", "ao", "as", "com", "da", "das", "de", "do", "dos", "e", "em",
        "mais", "mas", "na", "nas", "no", "nos", "nao", "o", "os", "ou",
        "para", "pela", "pelo", "por", "que", "se", "sem", "seu", "sua",
        "um", "uma",
    ],
    "dutch": [
        "aan", "als", "bij", "dat", "de", "den", "der", "des", "deze",
        "die", "dit", "doch", "een", "en", "er", "haar", "heeft", "hem",
        "het", "hij", "hoe", "hun", "ik", "in", "is", "je", "kan", "maar",
        "met", "mij", "naar", "niet", "nog", "nu", "of", "om", "ook", "op",
        "te", "tot", "uit", "van", "voor", "was", "wat", "zijn", "zo",
    ],
    "danish": [
        "af", "alle", "at", "da", "de", "den", "denne", "der", "det",
        "dette", "en", "er", "et", "for", "fra", "han", "har", "hun", "i",
        "ikke", "jeg", "med", "men", "og", "om", "op", "pa", "som", "til",
        "var", "vi", "vil",
    ],
    "swedish": [
        "alla", "att", "av", "de", "den", "det", "du", "efter", "en",
        "ett", "for", "fran", "han", "har", "hon", "i", "inte", "jag",
        "med", "men", "och", "om", "pa", "som", "till", "var", "vi", "vid",
    ],
    "norwegian": [
        "av", "at", "de", "den", "det", "du", "en", "er", "et", "for",
        "fra", "han", "har", "hun", "i", "ikke", "jeg", "med", "men", "og",
        "om", "pa", "som", "til", "var", "vi", "vil",
    ],
    "russian": [
        "и", "в", "во", "не", "что", "он", "на", "я", "с", "со", "как",
        "а", "то", "все", "она", "так", "его", "но", "да", "ты", "к", "у",
        "же", "вы", "за", "бы", "по", "ее", "мне", "было", "вот", "от",
        "меня", "еще", "нет", "о", "из", "ему", "был", "или", "это", "мы",
        "они", "для", "при", "чем", "есть",
    ],
    "arabic": [
        "في", "من", "على", "إلى", "عن", "أن", "إن", "هذا", "هذه", "ذلك",
        "التي", "الذي", "كان", "كانت", "لم", "لا", "ما", "مع", "هو", "هي",
        "قد", "كل", "بعد", "قبل", "حتى", "إذا", "ثم", "أو", "و", "يا",
        "لكن", "بين", "عند", "غير", "بعض", "كما",
    ],
    "finnish": [
        "ja", "on", "ei", "se", "että", "oli", "hän", "mutta", "joka",
        "ovat", "kun", "niin", "myös", "tai", "ole", "sen", "sitä", "jos",
        "he", "kuin", "mitä", "tämä", "siitä", "nyt", "vain", "me", "vielä",
        "jo", "voi", "olla", "hänen", "sekä",
    ],
    "hungarian": [
        "a", "az", "és", "hogy", "nem", "is", "egy", "ez", "volt", "de",
        "meg", "csak", "ha", "már", "mint", "el", "van", "vagy", "még",
        "azt", "aki", "ki", "mi", "le", "fel", "be", "te", "ami", "olyan",
        "arra", "után", "akkor", "annak", "lesz", "lehet",
    ],
    "romanian": [
        "și", "de", "la", "cu", "în", "pe", "un", "o", "ce", "nu", "se",
        "este", "din", "mai", "care", "sa", "să", "ca", "pentru", "dar",
        "fi", "au", "era", "lui", "ei", "al", "ale", "sau", "dacă", "după",
        "fost", "sunt", "când", "prin",
    ],
    "turkish": [
        "ve", "bir", "bu", "da", "de", "ne", "için", "ile", "mi", "ama",
        "o", "çok", "daha", "gibi", "ki", "en", "her", "ben", "sen", "biz",
        "siz", "onlar", "var", "yok", "kadar", "sonra", "önce", "olarak",
        "ise", "ya", "hem", "veya", "ancak", "şu", "tüm",
    ],
    "indonesian": [
        "yang", "dan", "di", "ini", "itu", "dengan", "untuk", "dari",
        "pada", "ke", "dalam", "adalah", "tidak", "akan", "ada", "juga",
        "atau", "sebagai", "oleh", "saya", "kami", "kita", "mereka", "dia",
        "bisa", "sudah", "telah", "karena", "jika", "saat", "lebih",
    ],
    "malay": [
        "yang", "dan", "di", "ini", "itu", "dengan", "untuk", "dari",
        "pada", "ke", "dalam", "adalah", "tidak", "akan", "ada", "juga",
        "atau", "sebagai", "oleh", "saya", "kami", "kita", "mereka", "dia",
        "boleh", "sudah", "telah", "kerana", "jika", "lebih",
    ],
    "vietnamese": [
        "và", "của", "là", "có", "trong", "được", "các", "những", "một",
        "cho", "với", "không", "này", "đã", "khi", "đến", "về", "như",
        "người", "cũng", "từ", "tại", "theo", "trên", "ra", "nên", "vào",
        "thì", "mà", "đó",
    ],
    "thai": [
        "และ", "ของ", "ที่", "ใน", "เป็น", "มี", "ได้", "การ", "ไม่", "ให้",
        "ว่า", "จะ", "มา", "กับ", "ก็", "แต่", "หรือ", "จาก", "ถึง", "ไป",
        "นี้", "นั้น", "อยู่", "ด้วย", "เมื่อ", "แล้ว", "ต้อง", "ตาม",
    ],
    "czech": [
        "a", "se", "na", "je", "v", "že", "s", "z", "do", "o", "i", "to",
        "k", "ve", "by", "ale", "si", "po", "jako", "za", "které", "který",
        "jsou", "nebo", "byl", "byla", "bylo", "jeho", "její", "tak",
        "když", "už", "při", "před", "také", "co",
    ],
    "greek": [
        "και", "το", "η", "ο", "του", "της", "των", "που", "με", "να",
        "σε", "για", "από", "τα", "την", "τον", "στο", "στη", "είναι",
        "δεν", "θα", "ως", "αυτό", "ότι", "αλλά", "οι", "τις", "τους",
        "ή", "κατά", "μια", "ένα", "είχε",
    ],
    "icelandic": [
        "og", "að", "í", "á", "er", "það", "sem", "um", "en", "ekki", "til",
        "var", "af", "við", "hann", "hún", "með", "fyrir", "eru", "þá",
        "hafa", "ef", "svo", "eða", "úr", "frá", "eftir", "nú", "sér",
    ],
    "polish": [
        "i", "w", "na", "z", "do", "to", "że", "się", "nie", "jest", "po",
        "a", "o", "jak", "ale", "co", "za", "od", "przez", "tak", "są",
        "czy", "być", "był", "była", "było", "ich", "jego", "jej", "dla",
        "przy", "tym", "które", "który", "oraz", "już", "tylko",
    ],
    "slovak": [
        "a", "sa", "na", "je", "v", "že", "s", "z", "do", "o", "i", "to",
        "k", "vo", "by", "ale", "si", "po", "ako", "za", "ktoré", "ktorý",
        "sú", "alebo", "bol", "bola", "bolo", "jeho", "jej", "tak", "keď",
        "už", "pri", "pred", "tiež", "čo",
    ],
    "slovenian": [
        "in", "je", "na", "se", "v", "da", "so", "za", "z", "s", "ki",
        "ne", "to", "po", "pa", "bi", "kot", "do", "iz", "o", "tudi",
        "bo", "od", "le", "še", "če", "ali", "pri", "ga", "bil", "bila",
        "bilo", "ta", "kaj",
    ],
    "estonian": [
        "ja", "on", "ei", "et", "see", "ta", "kui", "oli", "ka", "ning",
        "mis", "oma", "aga", "siis", "või", "nii", "seda", "tema", "selle",
        "veel", "juba", "kes", "küll", "välja", "üle", "pole", "ole",
    ],
    "latvian": [
        "un", "ir", "no", "ar", "uz", "par", "ka", "kā", "bet", "tas",
        "tā", "šis", "šī", "viņš", "viņa", "es", "mēs", "jūs", "tie",
        "tika", "bija", "būs", "var", "pēc", "pie", "vai", "jau", "arī",
        "tikai", "savu",
    ],
    "lithuanian": [
        "ir", "yra", "į", "iš", "su", "ant", "apie", "kad", "bet", "tai",
        "šis", "ši", "jis", "ji", "aš", "mes", "jūs", "jie", "buvo", "bus",
        "gali", "po", "prie", "ar", "jau", "taip", "tik", "savo", "kaip",
        "dėl", "nuo", "per",
    ],
    # ja/zh: ES routes these through the segmenting `cjk` analyzer rather than
    # a stopword list; this analyzer tokenizes unsegmented CJK text as whole
    # codepoint runs, so a word list would never match — empty by design.
    "japanese": [],
    "chinese": [],
}


def stopword_ids(language: str, vocab_size: int) -> set[int]:
    """FNV-hash the language's stopwords into the analyzer's id space."""
    from .loader import fnv1a_id

    words = STOPWORDS.get(language)
    if words is None:
        raise ValueError(f"No stopword list for {language!r}; known: {sorted(STOPWORDS)}")
    return {fnv1a_id(w, vocab_size) for w in words}

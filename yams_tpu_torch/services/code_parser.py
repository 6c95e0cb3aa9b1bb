"""Parser-grade symbol extraction for the reference's full grammar set.

The tree-sitter tier replacement (reference:
plugins/symbol_extractor_treesitter/, 2,826 LoC — grammar
-driven definition extraction). tree-sitter is not a dependency here,
so this module implements what the symbol surface actually needs from it:

  1. a real lexer per language family — comments, strings (incl. raw/
     template/backtick forms), char literals vs Rust lifetimes — so nothing
     inside a comment or string can ever surface as a symbol (the failure
     mode of the regex tier), with exact line numbers;
  2. token-stream scanners with a brace-depth context stack, producing
     nesting-QUALIFIED names (namespace::Class::method, Receiver.Method,
     impl-Type::fn, class.method) the way a grammar walk would.

Python keeps its stdlib-ast tier in symbol_service; C/C++, JS/TS, Go, Rust,
Java, C#, Kotlin, Swift, PHP, Dart, Perl, R, SQL, Solidity and Zig route
here — the reference plugin's full grammar set. Detection strategy differs
by family: brace languages where `ident(args)..{` implies definition
(C-family, Java, C#, Dart) vs languages where that shape is a trailing-
lambda CALL and only decl keywords count (Kotlin, Swift), vs keyword/
statement languages (Perl, R, SQL). The regex tier remains the fallback.

Copied from yams_tpu/services/code_parser.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(slots=True)
class Tok:
    kind: str   # id | punct | str | num | pp
    val: str
    line: int


_C_KEYWORDS = frozenset((
    "if else for while do switch case default return break continue goto "
    "sizeof alignof typeof decltype new delete throw try catch static_assert "
    "operator template typename using namespace class struct union enum "
    "public private protected virtual override final const constexpr "
    "consteval constinit static extern inline friend explicit noexcept "
    "volatile register mutable auto void int char short long float double "
    "bool unsigned signed wchar_t char8_t char16_t char32_t this nullptr "
    "true false and or not co_await co_return co_yield requires concept "
    "typedef union export import module").split())

_JS_KEYWORDS = frozenset((
    "if else for while do switch case default return break continue "
    "function class const let var new delete typeof instanceof in of "
    "try catch finally throw yield await async static get set "
    "import export from as extends super this null undefined true false "
    "void with debugger interface type enum namespace declare abstract "
    "implements public private protected readonly constructor").split())

_GO_KEYWORDS = frozenset((
    "if else for range switch case default return break continue goto "
    "func type struct interface map chan go defer select const var "
    "package import fallthrough true false nil iota make new len cap "
    "append copy panic recover print println").split())

_RUST_KEYWORDS = frozenset((
    "if else for while loop match return break continue fn struct enum "
    "trait impl mod use pub crate super self Self const static let mut "
    "ref move async await dyn where unsafe extern type as in true false "
    "macro_rules union box").split())

_JAVA_KEYWORDS = frozenset((
    "abstract assert boolean break byte case catch char class const "
    "continue default do double else enum extends final finally float for "
    "goto if implements import instanceof int interface long native new "
    "package private protected public return short static strictfp super "
    "switch synchronized this throw throws transient try void volatile "
    "while record sealed permits yield var true false null").split())

_CS_KEYWORDS = frozenset((
    "abstract as base bool break byte case catch char checked class const "
    "continue decimal default delegate do double else enum event explicit "
    "extern false finally fixed float for foreach goto if implicit in int "
    "interface internal is lock long namespace new null object operator "
    "out override params private protected public readonly ref return "
    "sbyte sealed short sizeof stackalloc static string struct switch this "
    "throw true try typeof uint ulong unchecked unsafe ushort using "
    "virtual void volatile while record required var when where yield "
    "async await partial nameof").split())

_KT_KEYWORDS = frozenset((
    "fun class interface object val var if else when for while do return "
    "break continue as is in by constructor init companion data sealed "
    "enum annotation inner open override private protected public internal "
    "abstract final lateinit const vararg noinline crossinline reified "
    "suspend operator infix inline external tailrec typealias import "
    "package this super null true false throw try catch finally where out "
    "get set").split())

_SWIFT_KEYWORDS = frozenset((
    "func class struct enum protocol extension actor var let if else guard "
    "switch case default for while repeat return break continue import "
    "typealias init deinit subscript static public private fileprivate "
    "internal open final override required convenience lazy weak unowned "
    "mutating nonmutating indirect associatedtype inout throws rethrows "
    "throw try catch defer where as is in nil true false self Self super "
    "some any await async willSet didSet get set").split())

_DART_KEYWORDS = frozenset((
    "abstract as assert async await base break case catch class const "
    "continue covariant default deferred do dynamic else enum export "
    "extends extension external factory false final finally for get hide "
    "if implements import in interface is late library mixin new null on "
    "operator part required rethrow return sealed set show static super "
    "switch sync this throw true try typedef var void when while with "
    "yield int double bool num").split())

_PHP_KEYWORDS = frozenset((
    "function class interface trait enum namespace use const var public "
    "private protected static abstract final if else elseif for foreach "
    "while do switch case default return break continue new clone echo "
    "print require include require_once include_once try catch finally "
    "throw global isset unset empty list array callable fn match yield "
    "true false null parent self extends implements instanceof insteadof "
    "readonly declare endif endwhile endfor endforeach endswitch "
    "and or xor not as").split())


def lex(text: str, lang: str) -> list[Tok]:
    """Tokenize enough of the language to make symbol scanning sound:
    comments and string bodies can never produce tokens."""
    toks: list[Tok] = []
    i, n = 0, len(text)
    line = 1
    go_backtick = lang == "go"
    js_template = lang in ("javascript", "typescript")
    c_pp = lang in ("c", "cpp")
    php = lang == "php"
    hash_comment = lang in ("php", "perl", "r")
    sql = lang == "sql"
    perl = lang == "perl"
    triple_str = lang in ("java", "csharp", "kotlin", "swift")
    kt_holes = lang == "kotlin"          # "${...}" holes in "" strings
    tick_ident = lang in ("kotlin", "swift")  # `quoted identifiers`

    def bump(seg: str) -> None:
        nonlocal line
        line += seg.count("\n")

    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        # comments
        if c == "/" and i + 1 < n:
            if text[i + 1] == "/":
                j = text.find("\n", i)
                i = n if j < 0 else j
                continue
            if text[i + 1] == "*":
                j = text.find("*/", i + 2)
                seg = text[i:(n if j < 0 else j + 2)]
                bump(seg)
                i = n if j < 0 else j + 2
                continue
        # php/perl/r: '#' line comments; sql: '--' line comments
        if hash_comment and c == "#":
            j = text.find("\n", i)
            i = n if j < 0 else j
            continue
        if sql and c == "-" and text[i + 1:i + 2] == "-":
            j = text.find("\n", i)
            i = n if j < 0 else j
            continue
        # perl POD blocks: '=word' at line start ... '=cut'
        if perl and c == "=" and (i == 0 or text[i - 1] == "\n") \
                and text[i + 1:i + 2].isalpha():
            j = text.find("\n=cut", i)
            end = n if j < 0 else text.find("\n", j + 1)
            if end < 0:
                end = n
            seg = text[i:end]
            bump(seg)
            i = end
            continue
        if php and text[i:i + 3] == "<<<":
            j = i + 3
            q = text[j] if text[j:j + 1] in "'\"" else ""
            if q:
                j += 1
            k = j
            while k < n and (text[k].isalnum() or text[k] == "_"):
                k += 1
            ident = text[j:k]
            if ident:
                if q and text[k:k + 1] == q:
                    k += 1
                pos, end = k, n
                while True:
                    nl = text.find("\n", pos)
                    if nl < 0:
                        break
                    ls = nl + 1
                    while ls < n and text[ls] in " \t":
                        ls += 1
                    if text[ls:ls + len(ident)] == ident:
                        end = ls + len(ident)
                        break
                    pos = nl + 1
                seg = text[i:end]
                toks.append(Tok("str", "", line))
                bump(seg)
                i = end
                continue
        # java/c#/kotlin/swift triple-quoted text blocks / raw strings
        if triple_str and text[i:i + 3] == '"""':
            j = text.find('"""', i + 3)
            seg = text[i:(n if j < 0 else j + 3)]
            toks.append(Tok("str", "", line))
            bump(seg)
            i = n if j < 0 else j + 3
            continue
        # kotlin/swift backtick-quoted identifiers
        if tick_ident and c == "`":
            j = text.find("`", i + 1)
            if j > 0:
                toks.append(Tok("id", text[i + 1:j], line))
                bump(text[i:j + 1])
                i = j + 1
                continue
        # C preprocessor directives: one 'pp' token carrying the directive
        if c_pp and c == "#":
            j = i
            while True:
                k = text.find("\n", j)
                if k < 0:
                    k = n
                if text[k - 1:k] == "\\":  # line continuation
                    j = k + 1
                    continue
                break
            seg = text[i:k]
            toks.append(Tok("pp", seg, line))
            bump(seg)
            i = k
            continue
        # rust raw strings r"..." / r#"..."# ; byte strings b"..."
        if lang == "rust" and c in "rb" and i + 1 < n:
            j = i
            if text[j] == "b":
                j += 1
            if j < n and text[j] == "r":
                j += 1
                hashes = 0
                while j < n and text[j] == "#":
                    hashes += 1
                    j += 1
                if j < n and text[j] == '"':
                    close = '"' + "#" * hashes
                    k = text.find(close, j + 1)
                    seg = text[i:(n if k < 0 else k + len(close))]
                    toks.append(Tok("str", "", line))
                    bump(seg)
                    i = n if k < 0 else k + len(close)
                    continue
        # C++ raw strings R"delim( ... )delim"
        if c_pp and c == "R" and text[i + 1:i + 2] == '"':
            p = text.find("(", i + 2)
            if 0 < p < i + 20:
                delim = text[i + 2:p]
                close = ")" + delim + '"'
                k = text.find(close, p + 1)
                seg = text[i:(n if k < 0 else k + len(close))]
                toks.append(Tok("str", "", line))
                bump(seg)
                i = n if k < 0 else k + len(close)
                continue
        # strings
        if c == '"' or (c == "'" and lang != "rust") or \
                (c == "`" and (go_backtick or js_template)):
            quote = c
            j = i + 1
            while j < n:
                if text[j] == "\\" and quote != "`":
                    j += 2
                    continue
                if ((quote == "`" and js_template)
                        or (quote == '"' and kt_holes)) and \
                        text[j] == "$" and text[j + 1:j + 2] == "{":
                    # template hole: skip to matching } (nesting-aware)
                    depth = 1
                    j += 2
                    while j < n and depth:
                        if text[j] == "{":
                            depth += 1
                        elif text[j] == "}":
                            depth -= 1
                        j += 1
                    continue
                if text[j] == quote:
                    break
                j += 1
            seg = text[i:j + 1]
            toks.append(Tok("str", "", line))
            bump(seg)
            i = j + 1
            continue
        # rust: char literal vs lifetime
        if c == "'" and lang == "rust":
            if (i + 2 < n and text[i + 2] == "'") or \
                    (i + 1 < n and text[i + 1] == "\\"):
                j = text.find("'", i + 2)
                i = n if j < 0 else j + 1
                toks.append(Tok("str", "", line))
                continue
            # lifetime: consume 'ident
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            i = j
            continue
        # identifiers
        if c.isalpha() or c == "_" or (c == "$" and (js_template or php)):
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] in "_$"):
                j += 1
            toks.append(Tok("id", text[i:j], line))
            i = j
            continue
        # numbers
        if c.isdigit():
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] in "._xXbo'"):
                j += 1
            toks.append(Tok("num", text[i:j], line))
            i = j
            continue
        # multi-char operators worth keeping whole
        two = text[i:i + 2]
        if two in ("::", "=>", "->", "<<", ">>", "&&", "||", ":=") or \
                (two == "<-" and lang == "r"):
            toks.append(Tok("punct", two, line))
            i += 2
            continue
        toks.append(Tok("punct", c, line))
        i += 1
    return toks


@dataclasses.dataclass(slots=True)
class Sym:
    name: str
    kind: str
    line: int


def _matching_paren(toks: list[Tok], i: int) -> int:
    """toks[i] == '('; return index just after its matching ')' (or len)."""
    depth = 0
    while i < len(toks):
        v = toks[i].val
        if toks[i].kind == "punct":
            if v == "(":
                depth += 1
            elif v == ")":
                depth -= 1
                if depth == 0:
                    return i + 1
        i += 1
    return len(toks)


# -- C / C++ --------------------------------------------------------------------

def scan_c(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    out: list[Sym] = []
    # (depth_at_open, kind, name) — namespaces/classes push context
    ctx: list[tuple[int, str, str]] = []
    depth = 0
    pending: tuple[str, str] | None = None  # (kind, name) awaiting '{'
    i = 0
    n = len(toks)

    def qual(name: str) -> str:
        parts = [c[2] for c in ctx
                 if c[1] in ("namespace", "class", "struct", "union")]
        return "::".join(parts + [name]) if parts else name

    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "pp":
            d = t.val.split(None, 2)
            if len(d) >= 2 and d[0] in ("#define", "#") and d[1] != "define":
                name = d[1].split("(")[0]
                if name.isidentifier():
                    out.append(Sym(name, "define", t.line))
            elif len(d) >= 3 and d[0] == "#" and d[1] == "define":
                name = d[2].split("(")[0].split()[0]
                if name.isidentifier():
                    out.append(Sym(name, "define", t.line))
            i += 1
            continue
        if t.kind == "id" and t.val in ("namespace", "class", "struct",
                                        "union", "enum"):
            kind = t.val
            j = i + 1
            if j < n and toks[j].kind == "id" and toks[j].val == "class":
                j += 1  # enum class
            if j < n and toks[j].kind == "id" and \
                    toks[j].val not in _C_KEYWORDS:
                name, line = toks[j].val, toks[j].line
                # find '{' before ';' (else it's a fwd decl / variable)
                k = j + 1
                while k < n and toks[k].val not in ("{", ";") :
                    k += 1
                if k < n and toks[k].val == "{":
                    out.append(Sym(qual(name), kind if kind != "namespace"
                                  else "namespace", line))
                    pending = (kind, name)
            i = j + 1
            continue
        if t.kind == "id" and t.val == "typedef":
            k = i + 1
            while k < n and toks[k].val != ";":
                k += 1
            if k - 1 > i and toks[k - 1].kind == "id":
                out.append(Sym(toks[k - 1].val, "typedef", toks[k - 1].line))
            i = k + 1
            continue
        if t.kind == "id" and t.val == "using" and i + 2 < n and \
                toks[i + 1].kind == "id" and toks[i + 2].val == "=":
            out.append(Sym(toks[i + 1].val, "using", toks[i + 1].line))
            i += 3
            continue
        # function definition: [qualified] ident '(' ... ')' [specifiers] '{'
        if t.kind == "id" and t.val not in _C_KEYWORDS and \
                i + 1 < n and toks[i + 1].val == "(":
            # collect a possibly-qualified name backwards: A::B::name, ~dtor
            name_parts = [t.val]
            b = i - 1
            while b >= 1 and toks[b].val == "::" and toks[b - 1].kind == "id":
                name_parts.insert(0, toks[b - 1].val)
                b -= 2
            if b >= 0 and toks[b].val == "~":
                name_parts[-1] = "~" + name_parts[-1]
            close = _matching_paren(toks, i + 1)
            k = close
            # skip trailing specifiers until '{', ';', or something else
            while k < n and (
                (toks[k].kind == "id" and toks[k].val in (
                    "const", "noexcept", "override", "final", "mutable",
                    "volatile", "try", "requires"))
                or toks[k].val in ("->", "::", "<", ">", "&", "&&", "*")
                or (toks[k].kind == "id" and toks[k - 1].val == "->")
            ):
                k += 1
            if k < n and toks[k].val == "{":
                name = "::".join(name_parts)
                if len(name_parts) == 1:
                    name = qual(name)
                in_class = any(c[1] in ("class", "struct", "union") for c in ctx)
                out.append(Sym(
                    name, "method" if (in_class or len(name_parts) > 1)
                    else "function", t.line))
                pending = ("function", name_parts[-1])
            i = close
            continue
        if t.val == "{" and t.kind == "punct":
            depth += 1
            if pending is not None:
                ctx.append((depth, pending[0], pending[1]))
                pending = None
            i += 1
            continue
        if t.val == "}" and t.kind == "punct":
            if ctx and ctx[-1][0] == depth:
                ctx.pop()
            depth -= 1
            i += 1
            continue
        if t.val in (";",):
            pending = None
        i += 1
    return out


# -- JavaScript / TypeScript ----------------------------------------------------

def scan_js(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    out: list[Sym] = []
    ctx: list[tuple[int, str, str]] = []   # (depth, kind, name)
    depth = 0
    pending: tuple[str, str] | None = None
    i = 0
    n = len(toks)

    def in_class() -> str | None:
        for d, k, nm in reversed(ctx):
            if k == "class":
                return nm
        return None

    while i < n and len(out) < max_symbols:
        t = toks[i]
        v = t.val
        if t.kind == "id" and v == "function":
            j = i + 1
            if j < n and toks[j].val == "*":
                j += 1
            if j < n and toks[j].kind == "id" and \
                    toks[j].val not in _JS_KEYWORDS:
                out.append(Sym(toks[j].val, "function", toks[j].line))
                pending = ("function", toks[j].val)
            i = j + 1
            continue
        if t.kind == "id" and v == "class" and i + 1 < n and \
                toks[i + 1].kind == "id":
            out.append(Sym(toks[i + 1].val, "class", toks[i + 1].line))
            pending = ("class", toks[i + 1].val)
            i += 2
            continue
        if t.kind == "id" and v in ("interface", "enum", "namespace") and \
                i + 1 < n and toks[i + 1].kind == "id" and \
                toks[i + 1].val not in _JS_KEYWORDS:
            out.append(Sym(toks[i + 1].val, v, toks[i + 1].line))
            pending = (v, toks[i + 1].val)
            i += 2
            continue
        if t.kind == "id" and v == "type" and i + 2 < n and \
                toks[i + 1].kind == "id" and toks[i + 2].val in ("=", "<"):
            out.append(Sym(toks[i + 1].val, "type", toks[i + 1].line))
            i += 3
            continue
        # const/let/var name = [async] ( | function | x =>
        if t.kind == "id" and v in ("const", "let", "var") and i + 2 < n \
                and toks[i + 1].kind == "id" and toks[i + 2].val == "=":
            j = i + 3
            if j < n and toks[j].kind == "id" and toks[j].val == "async":
                j += 1
            is_fn = False
            if j < n:
                if toks[j].val == "(":
                    k = _matching_paren(toks, j)
                    is_fn = k < n and toks[k].val == "=>"
                elif toks[j].val == "function":
                    is_fn = True
                elif toks[j].kind == "id" and j + 1 < n and \
                        toks[j + 1].val == "=>":
                    is_fn = True
            if is_fn:
                out.append(Sym(toks[i + 1].val, "function", toks[i + 1].line))
            i += 3
            continue
        # class-body methods: ident '(' ... ')' '{' directly under a class
        cls = in_class()
        if cls and t.kind == "id" and \
                (v not in _JS_KEYWORDS or v == "constructor") and \
                ctx[-1][1] == "class" and depth == ctx[-1][0] and \
                i + 1 < n and toks[i + 1].val == "(":
            k = _matching_paren(toks, i + 1)
            if k < n and toks[k].val == "{":
                out.append(Sym(f"{cls}.{v}", "method", t.line))
                pending = ("method", v)
            i = k
            continue
        if cls and t.kind == "id" and v in ("get", "set", "static", "async") \
                and depth == ctx[-1][0]:
            i += 1
            continue
        if v == "{" and t.kind == "punct":
            depth += 1
            if pending is not None:
                ctx.append((depth, pending[0], pending[1]))
                pending = None
            i += 1
            continue
        if v == "}" and t.kind == "punct":
            if ctx and ctx[-1][0] == depth:
                ctx.pop()
            depth -= 1
            i += 1
            continue
        if v in (";", "=") and pending and pending[0] != "class":
            pending = None
        i += 1
    return out


# -- Go -------------------------------------------------------------------------

def scan_go(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    out: list[Sym] = []
    i = 0
    n = len(toks)
    depth = 0
    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "punct":
            if t.val == "{":
                depth += 1
            elif t.val == "}":
                depth -= 1
            i += 1
            continue
        if t.kind == "id" and t.val == "func" and depth == 0:
            j = i + 1
            recv = None
            if j < n and toks[j].val == "(":
                # receiver: (r *Type) — type is last id before ')'
                k = _matching_paren(toks, j)
                ids = [x.val for x in toks[j:k] if x.kind == "id"]
                recv = ids[-1] if ids else None
                j = k
            if j < n and toks[j].kind == "id" and \
                    toks[j].val not in _GO_KEYWORDS:
                name = f"{recv}.{toks[j].val}" if recv else toks[j].val
                out.append(Sym(name, "method" if recv else "function",
                               toks[j].line))
            i = j + 1
            continue
        if t.kind == "id" and t.val == "type" and depth == 0 and i + 1 < n:
            if toks[i + 1].val == "(":  # grouped type block
                k = _matching_paren(toks, i + 1)
                i = k
                continue
            if toks[i + 1].kind == "id":
                kind = "type"
                if i + 2 < n and toks[i + 2].kind == "id":
                    if toks[i + 2].val == "interface":
                        kind = "interface"
                    elif toks[i + 2].val == "struct":
                        kind = "struct"
                out.append(Sym(toks[i + 1].val, kind, toks[i + 1].line))
            i += 2
            continue
        if t.kind == "id" and t.val in ("const", "var") and depth == 0 \
                and i + 1 < n:
            kind = "const" if t.val == "const" else "var"
            if toks[i + 1].val == "(":
                # grouped block: names are idents at the start of each line
                k = _matching_paren(toks, i + 1)
                last_line = -1
                for x in toks[i + 2:k - 1]:
                    if x.kind == "id" and x.line != last_line and \
                            x.val not in _GO_KEYWORDS:
                        out.append(Sym(x.val, kind, x.line))
                        last_line = x.line
                i = k
                continue
            if toks[i + 1].kind == "id":
                out.append(Sym(toks[i + 1].val, kind, toks[i + 1].line))
            i += 2
            continue
        i += 1
    return out


# -- Rust -----------------------------------------------------------------------

def scan_rust(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    out: list[Sym] = []
    ctx: list[tuple[int, str, str]] = []   # (depth, kind, name)
    depth = 0
    pending: tuple[str, str] | None = None
    i = 0
    n = len(toks)

    def qual(name: str) -> str:
        parts = [c[2] for c in ctx if c[1] in ("mod", "impl")]
        return "::".join(parts + [name]) if parts else name

    while i < n and len(out) < max_symbols:
        t = toks[i]
        v = t.val
        if t.kind == "id" and v == "impl":
            # impl [<..>] Type | impl [<..>] Trait for Type — target = Type
            j = i + 1
            if j < n and toks[j].val == "<":
                g = 1
                j += 1
                while j < n and g:
                    if toks[j].val == "<":
                        g += 1
                    elif toks[j].val == ">":
                        g -= 1
                    j += 1
            ids = []
            k = j
            target = None
            while k < n and toks[k].val != "{" and toks[k].val != ";":
                if toks[k].kind == "id" and toks[k].val == "for":
                    ids = []  # everything after 'for' is the target
                elif toks[k].kind == "id" and \
                        toks[k].val not in _RUST_KEYWORDS:
                    ids.append(toks[k].val)
                k += 1
            if ids:
                target = ids[0]
            if k < n and toks[k].val == "{" and target:
                pending = ("impl", target)
            i = k
            continue
        if t.kind == "id" and v == "mod" and i + 1 < n and \
                toks[i + 1].kind == "id":
            name = toks[i + 1].val
            k = i + 2
            if k < n and toks[k].val == "{":
                out.append(Sym(qual(name), "module", toks[i + 1].line))
                pending = ("mod", name)
            i += 2
            continue
        if t.kind == "id" and v == "fn" and i + 1 < n and \
                toks[i + 1].kind == "id":
            out.append(Sym(qual(toks[i + 1].val),
                           "method" if any(c[1] == "impl" for c in ctx)
                           else "function", toks[i + 1].line))
            pending = ("fn", toks[i + 1].val)
            i += 2
            continue
        if t.kind == "id" and v in ("struct", "enum", "trait", "union") and \
                i + 1 < n and toks[i + 1].kind == "id":
            out.append(Sym(qual(toks[i + 1].val), v, toks[i + 1].line))
            if v in ("enum", "trait", "union"):
                pending = (v, toks[i + 1].val) if v == "trait" else None
            i += 2
            continue
        if t.kind == "id" and v == "macro_rules" and i + 2 < n and \
                toks[i + 1].val == "!" and toks[i + 2].kind == "id":
            out.append(Sym(toks[i + 2].val, "macro", toks[i + 2].line))
            i += 3
            continue
        if t.kind == "id" and v in ("const", "static") and i + 1 < n and \
                toks[i + 1].kind == "id" and \
                toks[i + 1].val not in _RUST_KEYWORDS and \
                i + 2 < n and toks[i + 2].val == ":":
            out.append(Sym(qual(toks[i + 1].val), "constant",
                           toks[i + 1].line))
            i += 2
            continue
        if v == "{" and t.kind == "punct":
            depth += 1
            if pending is not None:
                ctx.append((depth, pending[0], pending[1]))
                pending = None
            i += 1
            continue
        if v == "}" and t.kind == "punct":
            if ctx and ctx[-1][0] == depth:
                ctx.pop()
            depth -= 1
            i += 1
            continue
        if v == ";":
            pending = None
        i += 1
    return out


# -- Java / C# -------------------------------------------------------------------

_JVM_TYPE_KINDS = ("class", "interface", "enum", "record", "struct",
                   "namespace", "object", "trait", "extension", "protocol",
                   "actor", "mixin")


def _skip_annotation(toks: list[Tok], i: int) -> int:
    """toks[i] == '@': skip @Dotted.Name(optional args); returns next index."""
    i += 1
    n = len(toks)
    while i + 1 < n and toks[i].kind == "id" and toks[i + 1].val == ".":
        i += 2
    if i < n and toks[i].kind == "id":
        i += 1
    if i < n and toks[i].val == "(":
        i = _matching_paren(toks, i)
    return i


def scan_jvm(toks: list[Tok], lang: str, max_symbols: int = 256) -> list[Sym]:
    """Java, C# and Dart: brace languages where `ident (args) ... {` after
    annotation stripping is a definition iff not preceded by '.'/'new'
    (dart adds `=>` expression bodies and `Class.named(...)` ctors)."""
    out: list[Sym] = []
    ctx: list[tuple[int, str, str]] = []
    depth = 0
    pending: tuple[str, str] | None = None
    kw = (_JAVA_KEYWORDS if lang == "java"
          else _DART_KEYWORDS if lang == "dart" else _CS_KEYWORDS)
    typekw = (("class", "interface", "enum", "record") if lang == "java"
              else ("class", "enum", "mixin", "extension") if lang == "dart"
              else ("class", "interface", "enum", "struct", "record"))
    dart = lang == "dart"
    i, n = 0, len(toks)

    def qual(name: str) -> str:
        parts = [c[2] for c in ctx if c[1] in _JVM_TYPE_KINDS]
        return ".".join(parts + [name]) if parts else name

    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "punct" and t.val == "@":
            i = _skip_annotation(toks, i)
            continue
        if lang == "csharp" and t.kind == "id" and t.val == "namespace":
            j = i + 1
            parts: list[str] = []
            while j < n and toks[j].kind == "id":
                parts.append(toks[j].val)
                j += 1
                if j < n and toks[j].val == ".":
                    j += 1
                else:
                    break
            if parts:
                name = ".".join(parts)
                out.append(Sym(qual(name), "namespace", t.line))
                if j < n and toks[j].val == "{":
                    pending = ("namespace", name)
                elif j < n and toks[j].val == ";":
                    ctx.append((-1, "namespace", name))  # file-scoped: to EOF
            i = j
            continue
        if t.kind == "id" and t.val in typekw:
            j = i + 1
            if j < n and toks[j].kind == "id" and toks[j].val not in kw:
                name, line = toks[j].val, toks[j].line
                out.append(Sym(qual(name), t.val, line))
                k = j + 1
                while k < n and toks[k].val not in ("{", ";"):
                    if toks[k].val == "(":
                        k = _matching_paren(toks, k)
                        continue
                    k += 1
                if k < n and toks[k].val == "{":
                    pending = (t.val, name)
                i = j + 1
            else:
                i += 1   # `where T : class`, anonymous class — keep `{` live
            continue
        if t.kind == "id" and t.val not in kw and i + 1 < n \
                and toks[i + 1].val == "(":
            prev = toks[i - 1].val if i > 0 else ""
            top = ctx[-1][2] if ctx else ""
            # dart named constructors: `ClassName.named(...)` inside the class
            named_ctor = (dart and prev == "." and i >= 2
                          and toks[i - 2].kind == "id" and toks[i - 2].val == top)
            if prev not in (".", "new") or named_ctor:
                close = _matching_paren(toks, i + 1)
                k = close
                while k < n:
                    v = toks[k].val
                    if v in ("{", ";") or (dart and v == "=>"):
                        break
                    if v == "(":               # c# ctor `: base(...)`
                        k = _matching_paren(toks, k)
                        continue
                    if toks[k].kind == "id" or v in (
                            ",", ".", ":", "<", ">", "[", "]") or (
                            dart and (toks[k].kind in ("num", "str")
                                      or v in ("=", "?"))):
                        k += 1
                        continue
                    break
                at_class_body = bool(ctx) and ctx[-1][1] in typekw
                is_def = k < n and (
                    toks[k].val == "{"
                    or (dart and toks[k].val == "=>")
                    # dart ctor with initializer-list-only body ends in ';'
                    # — only AT class-body depth (deeper it's a call)
                    or (dart and toks[k].val == ";" and at_class_body
                        and (t.val == top or named_ctor)))
                if is_def:
                    in_type = any(c[1] in typekw for c in ctx)
                    kind = ("constructor" if (t.val == top or named_ctor)
                            else "method" if in_type else "function")
                    # qual() already prefixes the class, so `Cls.named(...)`
                    # lands as Cls.named without further assembly
                    out.append(Sym(qual(t.val), kind, t.line))
                    if toks[k].val == "{":
                        pending = ("function", t.val)
                i = close
                continue
        if lang == "csharp" and t.kind == "id" and t.val not in kw \
                and i + 2 < n and toks[i + 1].val == "{" \
                and toks[i + 2].kind == "id" \
                and toks[i + 2].val in ("get", "set", "init") \
                and any(c[1] in typekw for c in ctx):
            out.append(Sym(qual(t.val), "property", t.line))
            i += 1
            continue
        if t.val == "{" and t.kind == "punct":
            depth += 1
            if pending is not None:
                ctx.append((depth, pending[0], pending[1]))
                pending = None
            i += 1
            continue
        if t.val == "}" and t.kind == "punct":
            if ctx and ctx[-1][0] == depth:
                ctx.pop()
            depth -= 1
            i += 1
            continue
        if t.val == ";":
            pending = None
        i += 1
    return out


# -- Kotlin ----------------------------------------------------------------------

def _skip_generics(toks: list[Tok], i: int) -> int:
    """toks[i] == '<': skip to just after the matching '>' (token level)."""
    d = 0
    n = len(toks)
    while i < n:
        if toks[i].val == "<":
            d += 1
        elif toks[i].val == ">":
            d -= 1
            if d == 0:
                return i + 1
        elif toks[i].val in ("{", ";"):
            return i   # bail: not generics after all
        i += 1
    return n


def scan_kotlin(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    """Kotlin: `fun`-keyword driven (bare `ident(..){` is a trailing-lambda
    CALL in kotlin, never a definition), receiver-qualified extension
    functions, class/interface/object decls with or without bodies."""
    out: list[Sym] = []
    ctx: list[tuple[int, str, str]] = []
    depth = 0
    pending: tuple[str, str] | None = None
    kw = _KT_KEYWORDS
    i, n = 0, len(toks)

    def qual(name: str) -> str:
        parts = [c[2] for c in ctx if c[1] in ("class", "interface", "object")]
        return ".".join(parts + [name]) if parts else name

    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "punct" and t.val == "@":
            i = _skip_annotation(toks, i)
            continue
        if t.kind == "id" and t.val in ("class", "interface", "object"):
            j = i + 1
            if j < n and toks[j].kind == "id" and toks[j].val not in kw:
                name, line = toks[j].val, toks[j].line
                out.append(Sym(qual(name), t.val, line))
                # body '{'? (primary ctor parens / supertypes may intervene;
                # stop at the next declaration keyword — kotlin has no ';')
                k = j + 1
                while k < n and toks[k].val != "{" and not (
                        toks[k].kind == "id" and toks[k].val in (
                            "fun", "class", "interface", "object", "val",
                            "var", "import", "package")):
                    if toks[k].val == "(":
                        k = _matching_paren(toks, k)
                        continue
                    k += 1
                if k < n and toks[k].val == "{":
                    pending = (t.val, name)
            i = j
            continue
        if t.kind == "id" and t.val == "constructor" and i + 1 < n \
                and toks[i + 1].val == "(":
            if any(c[1] in ("class", "object") for c in ctx):
                out.append(Sym(qual("constructor"), "constructor", t.line))
            i = _matching_paren(toks, i + 1)
            continue
        if t.kind == "id" and t.val == "fun":
            j = i + 1
            if j < n and toks[j].val == "<":
                j = _skip_generics(toks, j)
            parts: list[str] = []
            # receiver chain: Type[.<G>] '.' ...
            while j < n and toks[j].kind == "id":
                k = j + 1
                if k < n and toks[k].val == "<":
                    k = _skip_generics(toks, k)
                if k < n and toks[k].val == ".":
                    parts.append(toks[j].val)
                    j = k + 1
                    continue
                break
            if j < n and toks[j].kind == "id" and toks[j].val not in kw \
                    and j + 1 < n:
                k = j + 1
                if k < n and toks[k].val == "<":
                    k = _skip_generics(toks, k)
                if k < n and toks[k].val == "(":
                    name = ".".join(parts + [toks[j].val])
                    out.append(Sym(
                        qual(name),
                        "method" if (ctx or parts) else "function",
                        toks[j].line))
                    close = _matching_paren(toks, k)
                    k2 = close
                    while k2 < n and toks[k2].val not in ("{", "=") and (
                            toks[k2].kind == "id" or toks[k2].val in (
                                ":", ".", "<", ">", ",", "?", "->",
                                "(", ")")):
                        k2 += 1
                    if k2 < n and toks[k2].val == "{":
                        pending = ("function", toks[j].val)
                    i = close
                    continue
            i = j if j > i else i + 1
            continue
        if t.val == "{" and t.kind == "punct":
            depth += 1
            if pending is not None:
                ctx.append((depth, pending[0], pending[1]))
                pending = None
            i += 1
            continue
        if t.val == "}" and t.kind == "punct":
            if ctx and ctx[-1][0] == depth:
                ctx.pop()
            depth -= 1
            i += 1
            continue
        i += 1
    return out


# -- Swift -----------------------------------------------------------------------

def scan_swift(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    """Swift: keyword-driven only (`foo(x) { y in ... }` is a trailing-
    closure CALL); extensions qualify members under the extended type."""
    out: list[Sym] = []
    ctx: list[tuple[int, str, str]] = []
    depth = 0
    pending: tuple[str, str] | None = None
    typekw = ("class", "struct", "enum", "protocol", "extension", "actor")
    i, n = 0, len(toks)

    def qual(name: str) -> str:
        parts = [c[2] for c in ctx if c[1] in typekw]
        return ".".join(parts + [name]) if parts else name

    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "punct" and t.val == "@":
            i = _skip_annotation(toks, i)
            continue
        if t.kind == "id" and t.val in typekw:
            j = i + 1
            parts: list[str] = []
            while j < n and toks[j].kind == "id":
                parts.append(toks[j].val)
                j += 1
                if j < n and toks[j].val == ".":
                    j += 1
                else:
                    break
            if parts:
                name = ".".join(parts)
                line = t.line
                if t.val != "extension":
                    out.append(Sym(qual(name), t.val, line))
                k = j
                while k < n and toks[k].val != "{":
                    if toks[k].val == "(":
                        k = _matching_paren(toks, k)
                        continue
                    if toks[k].val == "<":
                        k = _skip_generics(toks, k)
                        continue
                    if toks[k].kind == "id" or toks[k].val in (":", ",", ">",
                                                               "&", "?"):
                        k += 1
                        continue
                    break
                if k < n and toks[k].val == "{":
                    pending = (t.val, name)
            i = j
            continue
        if t.kind == "id" and t.val == "func":
            j = i + 1
            if j < n and (toks[j].kind == "id" or toks[j].val == "`"):
                name, line = toks[j].val, toks[j].line
                k = j + 1
                if k < n and toks[k].val == "<":
                    k = _skip_generics(toks, k)
                if k < n and toks[k].val == "(":
                    out.append(Sym(
                        qual(name), "method" if ctx else "function", line))
                    close = _matching_paren(toks, k)
                    k2 = close
                    while k2 < n and toks[k2].val != "{" and (
                            toks[k2].kind == "id" or toks[k2].val in (
                                "->", ".", "<", ">", ",", "?", "!", "(",
                                ")", "[", "]", "&")):
                        k2 += 1
                    if k2 < n and toks[k2].val == "{":
                        pending = ("function", name)
                    i = close
                    continue
            i = j
            continue
        if t.kind == "id" and t.val == "init" and i + 1 < n \
                and toks[i + 1].val in ("(", "?") and ctx:
            out.append(Sym(qual("init"), "constructor", t.line))
            i += 1
            continue
        if t.kind == "id" and t.val == "typealias" and i + 1 < n \
                and toks[i + 1].kind == "id":
            out.append(Sym(qual(toks[i + 1].val), "typedef",
                           toks[i + 1].line))
            i += 2
            continue
        if t.val == "{" and t.kind == "punct":
            depth += 1
            if pending is not None:
                ctx.append((depth, pending[0], pending[1]))
                pending = None
            i += 1
            continue
        if t.val == "}" and t.kind == "punct":
            if ctx and ctx[-1][0] == depth:
                ctx.pop()
            depth -= 1
            i += 1
            continue
        i += 1
    return out


# -- PHP -------------------------------------------------------------------------

def scan_php(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    out: list[Sym] = []
    ctx: list[tuple[int, str, str]] = []
    depth = 0
    pending: tuple[str, str] | None = None
    kw = _PHP_KEYWORDS
    ns = ""
    i, n = 0, len(toks)

    def qual(name: str) -> str:
        parts = [c[2] for c in ctx
                 if c[1] in ("class", "interface", "trait", "enum")]
        body = ".".join(parts + [name]) if parts else name
        return f"{ns}\\{body}" if ns else body

    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "id" and t.val == "namespace":
            j = i + 1
            parts: list[str] = []
            while j < n and toks[j].kind == "id":
                parts.append(toks[j].val)
                j += 1
                if j < n and toks[j].val == "\\":
                    j += 1
                else:
                    break
            if parts:
                ns = "\\".join(parts)
                out.append(Sym(ns, "namespace", t.line))
            i = j
            continue
        if t.kind == "id" and t.val in ("class", "interface", "trait",
                                        "enum"):
            j = i + 1
            if j < n and toks[j].kind == "id" and toks[j].val not in kw:
                name, line = toks[j].val, toks[j].line
                out.append(Sym(qual(name), t.val, line))
                k = j + 1
                while k < n and toks[k].val not in ("{", ";"):
                    k += 1
                if k < n and toks[k].val == "{":
                    pending = (t.val, name)
                i = j + 1
            else:
                i += 1   # `new class {` anonymous — keep `{` live
            continue
        if t.kind == "id" and t.val == "function":
            j = i + 1
            if j < n and toks[j].val == "&":
                j += 1
            if j < n and toks[j].kind == "id" and toks[j].val not in kw:
                in_class = any(c[1] in ("class", "interface", "trait", "enum")
                               for c in ctx)
                out.append(Sym(qual(toks[j].val),
                               "method" if in_class else "function",
                               toks[j].line))
                if j + 1 < n and toks[j + 1].val == "(":
                    close = _matching_paren(toks, j + 1)
                    k = close
                    while k < n and toks[k].val not in ("{", ";") and (
                            toks[k].kind == "id"
                            or toks[k].val in (":", "?", "\\", "|")):
                        k += 1
                    if k < n and toks[k].val == "{":
                        pending = ("function", toks[j].val)
                    i = close
                    continue
            i = j
            continue
        if t.kind == "id" and t.val == "const" and i + 1 < n \
                and toks[i + 1].kind == "id":
            out.append(Sym(qual(toks[i + 1].val), "constant",
                           toks[i + 1].line))
            i += 2
            continue
        if t.val == "{" and t.kind == "punct":
            depth += 1
            if pending is not None:
                ctx.append((depth, pending[0], pending[1]))
                pending = None
            i += 1
            continue
        if t.val == "}" and t.kind == "punct":
            if ctx and ctx[-1][0] == depth:
                ctx.pop()
            depth -= 1
            i += 1
            continue
        if t.val == ";":
            pending = None
        i += 1
    return out


# -- Perl ------------------------------------------------------------------------

def scan_perl(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    out: list[Sym] = []
    pkg = ""
    i, n = 0, len(toks)
    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "id" and t.val == "package" and i + 1 < n \
                and toks[i + 1].kind == "id":
            parts = [toks[i + 1].val]
            j = i + 2
            while j + 1 < n and toks[j].val == "::" \
                    and toks[j + 1].kind == "id":
                parts.append(toks[j + 1].val)
                j += 2
            pkg = "::".join(parts)
            out.append(Sym(pkg, "package", toks[i + 1].line))
            i = j
            continue
        if t.kind == "id" and t.val == "sub" and i + 1 < n \
                and toks[i + 1].kind == "id":
            name = toks[i + 1].val
            out.append(Sym(f"{pkg}::{name}" if pkg else name, "function",
                           toks[i + 1].line))
            i += 2
            continue
        i += 1
    return out


# -- R ---------------------------------------------------------------------------

def scan_r(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    """`name <- function(` / `name = function(` (dotted R names included)."""
    out: list[Sym] = []
    i, n = 0, len(toks)
    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "id":
            # collect a dotted/underscored R name: my.helper_fn
            j = i
            parts = [toks[j].val]
            while j + 2 < n and toks[j + 1].val == "." \
                    and toks[j + 2].kind == "id":
                parts.append(toks[j + 2].val)
                j += 2
            if j + 2 < n and toks[j + 1].val in ("<-", "=") \
                    and toks[j + 2].kind == "id" \
                    and toks[j + 2].val == "function":
                out.append(Sym(".".join(parts), "function", t.line))
                i = j + 3
                continue
            i = j + 1
            continue
        i += 1
    return out


# -- SQL -------------------------------------------------------------------------

def scan_sql(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    """CREATE [OR REPLACE|TEMP|UNIQUE|MATERIALIZED] <kind> [IF NOT EXISTS]
    [schema.]name — case-insensitive."""
    out: list[Sym] = []
    kinds = ("table", "view", "index", "function", "procedure", "trigger",
             "schema", "database", "sequence", "type")
    i, n = 0, len(toks)
    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "id" and t.val.lower() == "create":
            j = i + 1
            while j < n and toks[j].kind == "id" and toks[j].val.lower() in (
                    "or", "replace", "temp", "temporary", "unique",
                    "materialized", "global", "local"):
                j += 1
            if j < n and toks[j].kind == "id" \
                    and toks[j].val.lower() in kinds:
                kind = toks[j].val.lower()
                k = j + 1
                while k < n and toks[k].kind == "id" \
                        and toks[k].val.lower() in ("if", "not", "exists"):
                    k += 1
                parts: list[str] = []
                while k < n and toks[k].kind == "id":
                    parts.append(toks[k].val)
                    k += 1
                    if k < n and toks[k].val == ".":
                        k += 1
                    else:
                        break
                if parts:
                    out.append(Sym(".".join(parts), kind, t.line))
                i = k
                continue
        i += 1
    return out


# -- Solidity --------------------------------------------------------------------

def scan_solidity(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    out: list[Sym] = []
    ctx: list[tuple[int, str, str]] = []
    depth = 0
    pending: tuple[str, str] | None = None
    typekw = ("contract", "interface", "library")
    i, n = 0, len(toks)

    def qual(name: str) -> str:
        parts = [c[2] for c in ctx if c[1] in typekw]
        return ".".join(parts + [name]) if parts else name

    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "id" and t.val in typekw and i + 1 < n \
                and toks[i + 1].kind == "id":
            name, line = toks[i + 1].val, toks[i + 1].line
            out.append(Sym(qual(name), t.val, line))
            k = i + 2
            while k < n and toks[k].val not in ("{", ";"):
                k += 1
            if k < n and toks[k].val == "{":
                pending = (t.val, name)
            i = i + 2
            continue
        if t.kind == "id" and t.val in ("function", "modifier", "event",
                                        "error", "struct", "enum") \
                and i + 1 < n and toks[i + 1].kind == "id":
            name, line = toks[i + 1].val, toks[i + 1].line
            kind = ("method" if t.val == "function" and ctx
                    else t.val if t.val != "function" else "function")
            out.append(Sym(qual(name), kind, line))
            j = i + 2
            if j < n and toks[j].val == "(":
                j = _matching_paren(toks, j)
            k = j
            while k < n and toks[k].val not in ("{", ";"):
                if toks[k].val == "(":
                    k = _matching_paren(toks, k)
                    continue
                k += 1
            if k < n and toks[k].val == "{":
                pending = ("function", name)
            i = j
            continue
        if t.val == "{" and t.kind == "punct":
            depth += 1
            if pending is not None:
                ctx.append((depth, pending[0], pending[1]))
                pending = None
            i += 1
            continue
        if t.val == "}" and t.kind == "punct":
            if ctx and ctx[-1][0] == depth:
                ctx.pop()
            depth -= 1
            i += 1
            continue
        if t.val == ";":
            pending = None
        i += 1
    return out


# -- Zig -------------------------------------------------------------------------

def scan_zig(toks: list[Tok], max_symbols: int = 256) -> list[Sym]:
    out: list[Sym] = []
    ctx: list[tuple[int, str, str]] = []
    depth = 0
    pending: tuple[str, str] | None = None
    i, n = 0, len(toks)

    def qual(name: str) -> str:
        parts = [c[2] for c in ctx if c[1] == "struct"]
        return ".".join(parts + [name]) if parts else name

    while i < n and len(out) < max_symbols:
        t = toks[i]
        if t.kind == "id" and t.val == "fn" and i + 2 < n \
                and toks[i + 1].kind == "id" and toks[i + 2].val == "(":
            name, line = toks[i + 1].val, toks[i + 1].line
            out.append(Sym(qual(name), "method" if ctx else "function", line))
            close = _matching_paren(toks, i + 2)
            k = close
            while k < n and toks[k].val != "{" and (
                    toks[k].kind == "id" or toks[k].val in (
                        "!", "?", ".", ",", "(", ")", "[", "]", "*")):
                if toks[k].val == "(":
                    k = _matching_paren(toks, k)
                    continue
                k += 1
            if k < n and toks[k].val == "{":
                pending = ("function", name)
            i = close
            continue
        if t.kind == "id" and t.val == "const" and i + 2 < n \
                and toks[i + 1].kind == "id" and toks[i + 2].val == "=":
            j = i + 3
            while j < n and toks[j].kind == "id" and toks[j].val in (
                    "packed", "extern"):
                j += 1
            if j < n and toks[j].kind == "id" and toks[j].val in (
                    "struct", "enum", "union", "opaque"):
                name, line = toks[i + 1].val, toks[i + 1].line
                out.append(Sym(qual(name), toks[j].val, line))
                k = j + 1
                while k < n and toks[k].val not in ("{", ";"):
                    if toks[k].val == "(":
                        k = _matching_paren(toks, k)
                        continue
                    k += 1
                if k < n and toks[k].val == "{":
                    pending = ("struct", name)
            i = i + 2
            continue
        if t.val == "{" and t.kind == "punct":
            depth += 1
            if pending is not None:
                ctx.append((depth, pending[0], pending[1]))
                pending = None
            i += 1
            continue
        if t.val == "}" and t.kind == "punct":
            if ctx and ctx[-1][0] == depth:
                ctx.pop()
            depth -= 1
            i += 1
            continue
        if t.val == ";":
            pending = None
        i += 1
    return out


_SCANNERS = {
    "c": scan_c, "cpp": scan_c,
    "javascript": scan_js, "typescript": scan_js,
    "go": scan_go, "rust": scan_rust,
    "java": lambda toks, m=256: scan_jvm(toks, "java", m),
    "csharp": lambda toks, m=256: scan_jvm(toks, "csharp", m),
    "dart": lambda toks, m=256: scan_jvm(toks, "dart", m),
    "kotlin": scan_kotlin, "swift": scan_swift, "php": scan_php,
    "perl": scan_perl, "r": scan_r, "sql": scan_sql,
    "solidity": scan_solidity, "zig": scan_zig,
}


def extract(text: str, lang: str, max_symbols: int = 256) -> list[Sym]:
    """Parser-tier extraction; returns [] for unsupported languages."""
    scanner = _SCANNERS.get(lang)
    if scanner is None:
        return []
    toks = lex(text[:500_000], "cpp" if lang in ("c", "cpp") else lang)
    syms = scanner(toks, max_symbols)
    seen: set[tuple[str, int]] = set()
    out = []
    for s in syms:
        key = (s.name, s.line)
        if key not in seen:
            seen.add(key)
            out.append(s)
    return out

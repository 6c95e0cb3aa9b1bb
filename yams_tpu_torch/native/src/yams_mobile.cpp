// yams_tpu mobile/C bindings: embed the retrieval system from any C host.
//
// Parity: include/yams/api/mobile_bindings.h (the reference's 196-symbol
// yams_mobile_* C ABI). This library speaks the daemon's framed protocol over
// AF_UNIX with the FLAG_JSON payload mode, so host apps exchange UTF-8 JSON
// strings and never need msgpack. Responses are returned as malloc'd JSON the
// caller frees with yams_mobile_free().
//
// Lifecycle: yams_mobile_connect -> yams_mobile_* calls -> yams_mobile_disconnect.
//
// Port of yams_tpu/native/src/yams_mobile.cpp for yams_tpu_torch. The ABI's
// symbols, structs and JSON are the original's; it departs only here:
//   - the embedded spawn runs the port's CLI
//     (-m yams_tpu_torch.cli.main --storage <wd> daemon start), whose daemon
//     opens on $YAMS_TPU_DEVICE (default cuda) since a C host cannot pass
//     --device;
//   - it execs python3, not python, which a host may not have on its PATH;
//   - the socket poll waits for the port's daemon to open its app on the
//     device (its first CUDA context and kernel builds), not a TPU compile.

#include <cstdint>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

#include <fcntl.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include "../include/yams_mobile.h"

extern "C" uint32_t ytn_crc32(const uint8_t* data, size_t n, uint32_t seed);

namespace {

constexpr uint32_t MAGIC = 0x59545044; // "YTPD"
constexpr uint8_t VERSION = 1;
constexpr uint8_t FLAG_MORE = 0x01;
constexpr uint8_t FLAG_JSON = 0x02;

#pragma pack(push, 1)
struct FrameHeader {
    uint32_t magic;
    uint8_t version;
    uint8_t flags;
    uint16_t reserved;
    uint32_t length;
    uint32_t crc;
};
#pragma pack(pop)
static_assert(sizeof(FrameHeader) == 16, "frame header must be 16 bytes");

struct Handle {
    int fd = -1;
    uint64_t next_id = 1;
};

bool write_all(int fd, const void* buf, size_t n) {
    const char* p = static_cast<const char*>(buf);
    while (n) {
        ssize_t w = ::write(fd, p, n);
        if (w <= 0) return false;
        p += w;
        n -= (size_t)w;
    }
    return true;
}

bool read_all(int fd, void* buf, size_t n) {
    char* p = static_cast<char*>(buf);
    while (n) {
        ssize_t r = ::read(fd, p, n);
        if (r <= 0) return false;
        p += r;
        n -= (size_t)r;
    }
    return true;
}

std::string json_escape(const char* s) {
    std::string out;
    for (const char* p = s; *p; ++p) {
        unsigned char c = (unsigned char)*p;
        switch (c) {
            case '"': out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\n': out += "\\n"; break;
            case '\r': out += "\\r"; break;
            case '\t': out += "\\t"; break;
            default:
                if (c < 0x20) {
                    char buf[8];
                    snprintf(buf, sizeof buf, "\\u%04x", c);
                    out += buf;
                } else {
                    out += (char)c;
                }
        }
    }
    return out;
}

char* dup_cstr(const std::string& s) {
    char* out = static_cast<char*>(malloc(s.size() + 1));
    if (out) memcpy(out, s.c_str(), s.size() + 1);
    return out;
}

// send one JSON request, receive the full (possibly chunked) JSON response
char* roundtrip(Handle* h, const std::string& payload) {
    FrameHeader hdr{MAGIC, VERSION, FLAG_JSON, 0,
                    (uint32_t)payload.size(),
                    ytn_crc32((const uint8_t*)payload.data(), payload.size(), 0)};
    if (!write_all(h->fd, &hdr, sizeof hdr)) return nullptr;
    if (!write_all(h->fd, payload.data(), payload.size())) return nullptr;
    std::string resp;
    for (;;) {
        FrameHeader rh;
        if (!read_all(h->fd, &rh, sizeof rh)) return nullptr;
        if (rh.magic != MAGIC || rh.length > (256u << 20)) return nullptr;
        std::string part(rh.length, '\0');
        if (!read_all(h->fd, part.data(), rh.length)) return nullptr;
        if (ytn_crc32((const uint8_t*)part.data(), part.size(), 0) != rh.crc)
            return nullptr;
        resp += part;
        if (!(rh.flags & FLAG_MORE)) break;
    }
    return dup_cstr(resp);
}

} // namespace

extern "C" {

int yams_mobile_abi_version() { return 1; }

// returns an opaque handle, or NULL on failure
void* yams_mobile_connect(const char* socket_path) {
    int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    strncpy(addr.sun_path, socket_path, sizeof(addr.sun_path) - 1);
    if (::connect(fd, (sockaddr*)&addr, sizeof addr) != 0) {
        ::close(fd);
        return nullptr;
    }
    auto* h = new Handle();
    h->fd = fd;
    return h;
}

void yams_mobile_disconnect(void* handle) {
    auto* h = static_cast<Handle*>(handle);
    if (!h) return;
    if (h->fd >= 0) ::close(h->fd);
    delete h;
}

void yams_mobile_free(char* s) { free(s); }

// raw escape hatch: send a complete JSON request object (must include "type")
char* yams_mobile_request(void* handle, const char* json_request) {
    auto* h = static_cast<Handle*>(handle);
    if (!h || !json_request) return nullptr;
    std::string payload(json_request);
    // inject an id if the caller's object lacks one (crude but sufficient:
    // we only add when the request doesn't contain "\"id\"")
    if (payload.find("\"id\"") == std::string::npos && payload.size() >= 2 &&
        payload.front() == '{') {
        char buf[48];
        snprintf(buf, sizeof buf, "{\"id\":%llu,",
                 (unsigned long long)h->next_id++);
        payload = std::string(buf) + payload.substr(1);
    }
    return roundtrip(h, payload);
}

char* yams_mobile_ping(void* handle) {
    return yams_mobile_request(handle, "{\"type\":\"ping\"}");
}

char* yams_mobile_status_json(void* handle, int detailed) {
    std::string req = std::string("{\"type\":\"status\",\"detailed\":") +
                      (detailed ? "true" : "false") + "}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_search(void* handle, const char* query, int limit,
                         const char* search_type) {
    std::string req = "{\"type\":\"search\",\"query\":\"" + json_escape(query) +
                      "\",\"limit\":" + std::to_string(limit > 0 ? limit : 10) +
                      ",\"search_type\":\"" +
                      json_escape(search_type ? search_type : "hybrid") + "\"}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_grep(void* handle, const char* pattern, int max_matches) {
    std::string req = "{\"type\":\"grep\",\"pattern\":\"" + json_escape(pattern) +
                      "\",\"max_matches\":" +
                      std::to_string(max_matches > 0 ? max_matches : 100) + "}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_add_text(void* handle, const char* name, const char* content) {
    std::string req = "{\"type\":\"add_bytes\",\"name\":\"" + json_escape(name) +
                      "\",\"data\":{\"__b64__\":\"";
    // base64-encode content
    static const char tbl[] =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    const unsigned char* d = (const unsigned char*)content;
    size_t n = strlen(content);
    for (size_t i = 0; i < n; i += 3) {
        uint32_t v = d[i] << 16;
        if (i + 1 < n) v |= d[i + 1] << 8;
        if (i + 2 < n) v |= d[i + 2];
        req += tbl[(v >> 18) & 63];
        req += tbl[(v >> 12) & 63];
        req += (i + 1 < n) ? tbl[(v >> 6) & 63] : '=';
        req += (i + 2 < n) ? tbl[v & 63] : '=';
    }
    req += "\"}}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_get_text(void* handle, const char* selector) {
    std::string req = "{\"type\":\"get_text\",\"selector\":\"" +
                      json_escape(selector) + "\"}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_get_metadata_json(void* handle, const char* selector) {
    std::string req = "{\"type\":\"get\",\"selector\":\"" +
                      json_escape(selector) + "\"}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_delete(void* handle, const char* selector) {
    std::string req = "{\"type\":\"delete\",\"selector\":\"" +
                      json_escape(selector) + "\"}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_list(void* handle, int limit) {
    std::string req = "{\"type\":\"list\",\"limit\":" +
                      std::to_string(limit > 0 ? limit : 50) + "}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_update_metadata(void* handle, const char* selector,
                                  const char* key, const char* value) {
    std::string req = "{\"type\":\"update\",\"selector\":\"" +
                      json_escape(selector) + "\",\"metadata\":{\"" +
                      json_escape(key) + "\":\"" + json_escape(value) + "\"}}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_graph_explore(void* handle, const char* query, int limit) {
    std::string req = "{\"type\":\"graph_explore\",\"query\":\"" +
                      json_escape(query) + "\",\"limit\":" +
                      std::to_string(limit > 0 ? limit : 25) + "}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_graph_related(void* handle, const char* selector, int limit) {
    std::string req = "{\"type\":\"graph_related\",\"selector\":\"" +
                      json_escape(selector) + "\",\"limit\":" +
                      std::to_string(limit > 0 ? limit : 20) + "}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_suggest_context(void* handle, const char* query, int limit) {
    std::string req = "{\"type\":\"suggest_context\",\"query\":\"" +
                      json_escape(query) + "\",\"limit\":" +
                      std::to_string(limit > 0 ? limit : 5) + "}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_session(void* handle, const char* op, const char* arg) {
    std::string req = "{\"type\":\"session\",\"op\":\"" + json_escape(op) +
                      "\"";
    if (arg && *arg)
        req += ",\"pattern\":\"" + std::string(json_escape(arg)) +
               "\",\"name\":\"" + json_escape(arg) + "\"";
    req += "}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_repair_json(void* handle, const char* ops_csv) {
    std::string req = "{\"type\":\"repair\",\"ops\":[";
    if (ops_csv && *ops_csv) {
        std::string cur;
        bool first = true;
        for (const char* p = ops_csv;; ++p) {
            if (*p == ',' || *p == '\0') {
                if (!cur.empty()) {
                    if (!first) req += ",";
                    req += "\"" + json_escape(cur.c_str()) + "\"";
                    first = false;
                    cur.clear();
                }
                if (*p == '\0') break;
            } else {
                cur += *p;
            }
        }
    }
    req += "]}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_doctor_json(void* handle) {
    return yams_mobile_request(handle, "{\"type\":\"doctor\"}");
}

char* yams_mobile_checkpoint(void* handle) {
    return yams_mobile_request(handle, "{\"type\":\"checkpoint\"}");
}

char* yams_mobile_embed(void* handle, const char* text) {
    std::string req = "{\"type\":\"embed\",\"texts\":[\"" + json_escape(text) +
                      "\"]}";
    return yams_mobile_request(handle, req.c_str());
}

char* yams_mobile_download_json(void* handle, const char* url) {
    std::string req = "{\"type\":\"download\",\"url\":\"" + json_escape(url) +
                      "\"}";
    return yams_mobile_request(handle, req.c_str());
}

} // extern "C"

// ---------------------------------------------------------------------------
// Typed context + result-handle layer (reference shape:
// include/yams/api/mobile_bindings.h — context_create/destroy, per-family
// *_execute functions returning opaque result handles with *_json /
// *_stats_json getters and *_destroy, plus last_error_message/get_version).
// Result handles own their memory; getters return borrowed pointers valid
// until the matching *_destroy.
// ---------------------------------------------------------------------------

// (file-local support types for the typed layer)

struct yams_mobile_context_t {
    void* conn = nullptr;          // Handle* from yams_mobile_connect
    std::string last_error;
};
using MobileContext = yams_mobile_context_t;

// -- minimal JSON DOM for the field-level typed getters ----------------------
// (reference: the mobile ABI exposes typed accessors so hosts never parse
// JSON; we parse the daemon's envelope once per handle, lazily)

struct JValue {
    enum Kind { NUL, BOOL, NUM, STR, ARR, OBJ };
    Kind kind = NUL;
    bool b = false;
    double num = 0.0;
    std::string str;
    std::vector<JValue> arr;
    std::vector<std::pair<std::string, JValue>> obj;

    const JValue* get(const std::string& key) const {
        if (kind != OBJ) return nullptr;
        for (const auto& kv : obj)
            if (kv.first == key) return &kv.second;
        return nullptr;
    }
    const JValue* at(size_t i) const {
        if (kind != ARR || i >= arr.size()) return nullptr;
        return &arr[i];
    }
};

struct JParser {
    const char* p;
    const char* end;
    int depth = 0;

    explicit JParser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

    void ws() { while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p; }

    bool lit(const char* s, size_t n) {
        if ((size_t)(end - p) < n || memcmp(p, s, n) != 0) return false;
        p += n;
        return true;
    }

    static void utf8_append(std::string& out, uint32_t cp) {
        if (cp < 0x80) out += (char)cp;
        else if (cp < 0x800) {
            out += (char)(0xC0 | (cp >> 6));
            out += (char)(0x80 | (cp & 0x3F));
        } else if (cp < 0x10000) {
            out += (char)(0xE0 | (cp >> 12));
            out += (char)(0x80 | ((cp >> 6) & 0x3F));
            out += (char)(0x80 | (cp & 0x3F));
        } else {
            out += (char)(0xF0 | (cp >> 18));
            out += (char)(0x80 | ((cp >> 12) & 0x3F));
            out += (char)(0x80 | ((cp >> 6) & 0x3F));
            out += (char)(0x80 | (cp & 0x3F));
        }
    }

    bool hex4(uint32_t& out) {
        if (end - p < 4) return false;
        out = 0;
        for (int i = 0; i < 4; ++i) {
            char c = *p++;
            out <<= 4;
            if (c >= '0' && c <= '9') out |= (uint32_t)(c - '0');
            else if (c >= 'a' && c <= 'f') out |= (uint32_t)(c - 'a' + 10);
            else if (c >= 'A' && c <= 'F') out |= (uint32_t)(c - 'A' + 10);
            else return false;
        }
        return true;
    }

    bool pstring(std::string& out) {
        if (p >= end || *p != '"') return false;
        ++p;
        while (p < end) {
            char c = *p++;
            if (c == '"') return true;
            if (c == '\\') {
                if (p >= end) return false;
                char e = *p++;
                switch (e) {
                    case '"': out += '"'; break;
                    case '\\': out += '\\'; break;
                    case '/': out += '/'; break;
                    case 'b': out += '\b'; break;
                    case 'f': out += '\f'; break;
                    case 'n': out += '\n'; break;
                    case 'r': out += '\r'; break;
                    case 't': out += '\t'; break;
                    case 'u': {
                        uint32_t cp;
                        if (!hex4(cp)) return false;
                        if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 &&
                            p[0] == '\\' && p[1] == 'u') {
                            p += 2;
                            uint32_t lo;
                            if (!hex4(lo)) return false;
                            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                        }
                        utf8_append(out, cp);
                        break;
                    }
                    default: return false;
                }
            } else {
                out += c;
            }
        }
        return false;
    }

    bool value(JValue& out) {
        if (++depth > 64) return false;
        ws();
        if (p >= end) return false;
        bool ok = false;
        if (*p == '{') {
            ++p;
            out.kind = JValue::OBJ;
            ws();
            if (p < end && *p == '}') { ++p; ok = true; }
            else {
                for (;;) {
                    std::string key;
                    ws();
                    if (!pstring(key)) break;
                    ws();
                    if (p >= end || *p++ != ':') break;
                    out.obj.emplace_back(std::move(key), JValue{});
                    if (!value(out.obj.back().second)) break;
                    ws();
                    if (p < end && *p == ',') { ++p; continue; }
                    if (p < end && *p == '}') { ++p; ok = true; }
                    break;
                }
            }
        } else if (*p == '[') {
            ++p;
            out.kind = JValue::ARR;
            ws();
            if (p < end && *p == ']') { ++p; ok = true; }
            else {
                for (;;) {
                    out.arr.emplace_back();
                    if (!value(out.arr.back())) break;
                    ws();
                    if (p < end && *p == ',') { ++p; continue; }
                    if (p < end && *p == ']') { ++p; ok = true; }
                    break;
                }
            }
        } else if (*p == '"') {
            out.kind = JValue::STR;
            ok = pstring(out.str);
        } else if (lit("true", 4)) {
            out.kind = JValue::BOOL; out.b = true; ok = true;
        } else if (lit("false", 5)) {
            out.kind = JValue::BOOL; out.b = false; ok = true;
        } else if (lit("null", 4)) {
            out.kind = JValue::NUL; ok = true;
        } else {
            char* after = nullptr;
            double d = strtod(p, &after);
            if (after > p && after <= end) {
                out.kind = JValue::NUM; out.num = d; p = after; ok = true;
            }
        }
        --depth;
        return ok;
    }
};

struct yams_mobile_result_t {
    std::string json;              // full daemon response envelope
    std::string stats;             // tiny summary: {"ok":...,"bytes":N}
    bool dom_tried = false;        // lazy parse state for typed getters
    bool dom_ok = false;
    JValue dom;

    const JValue* root() {
        if (!dom_tried) {
            dom_tried = true;
            JParser jp(json);
            dom_ok = jp.value(dom);
            if (dom_ok) {
                jp.ws();
                if (jp.p != jp.end) dom_ok = false;   // trailing garbage
            }
        }
        return dom_ok ? &dom : nullptr;
    }
};
using MobileResult = yams_mobile_result_t;

// dotted-path lookup: "hits.3.score" (numeric segment = array index)
const JValue* jwalk(const JValue* v, const char* path) {
    const char* s = path;
    while (*s && v) {
        const char* dot = strchr(s, '.');
        std::string seg = dot ? std::string(s, dot - s) : std::string(s);
        if (!seg.empty() && seg.find_first_not_of("0123456789") == std::string::npos)
            v = v->at((size_t)strtoull(seg.c_str(), nullptr, 10));
        else
            v = v->get(seg);
        if (!dot) break;
        s = dot + 1;
    }
    return v;
}

// paths resolve inside the daemon's {"ok":..,"result":{...}} envelope first,
// then at the top level ("ok"/"id" and un-enveloped payloads)
const JValue* jresolve(MobileResult* r, const char* path) {
    if (!r || !path) return nullptr;
    const JValue* root = r->root();
    if (!root) return nullptr;
    if (const JValue* res = root->get("result"))
        if (const JValue* v = jwalk(res, path)) return v;
    return jwalk(root, path);
}

// thread-local extended error (reference: yams_mobile_last_error_message is
// per-thread and valid until the next API call on the same thread)
thread_local std::string g_thread_error;

void set_tl_error(const std::string& msg) { g_thread_error = msg; }

yams_mobile_status run_request(MobileContext* ctx, const std::string& req,
                               MobileResult** out) {
    if (!ctx || !out) {
        set_tl_error("invalid argument");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    *out = nullptr;
    char* resp = yams_mobile_request(ctx->conn, req.c_str());
    if (!resp) {
        ctx->last_error = "transport failure (socket closed or bad frame)";
        set_tl_error(ctx->last_error);
        return YAMS_MOBILE_STATUS_UNAVAILABLE;
    }
    auto* r = new MobileResult();
    r->json.assign(resp);
    free(resp);
    // parse the envelope: substring-matching "ok":true would misclassify
    // error payloads that echo user-controlled text containing that token
    const JValue* env = r->root();
    const JValue* okv = env ? env->get("ok") : nullptr;
    bool ok = okv && okv->kind == JValue::BOOL && okv->b;
    r->stats = std::string("{\"ok\":") + (ok ? "true" : "false") +
               ",\"bytes\":" + std::to_string(r->json.size()) + "}";
    if (!ok) {
        ctx->last_error = r->json;
        set_tl_error(r->json);
        *out = r;
        return r->json.find("not found") != std::string::npos
                   ? YAMS_MOBILE_STATUS_NOT_FOUND
                   : YAMS_MOBILE_STATUS_INTERNAL_ERROR;
    }
    ctx->last_error.clear();
    set_tl_error("");
    *out = r;
    return YAMS_MOBILE_STATUS_OK;
}

// request-building helpers -----------------------------------------------------

std::string jfield(const char* key, const char* val) {
    return std::string("\"") + key + "\":\"" + json_escape(val ? val : "") +
           "\"";
}

void append_str_array(std::string& req, const char* key, const char** arr,
                      size_t n) {
    if (!arr || !n) return;
    req += ",\"";
    req += key;
    req += "\":[";
    for (size_t i = 0; i < n; ++i) {
        if (i) req += ",";
        req += "\"" + json_escape(arr[i] ? arr[i] : "") + "\"";
    }
    req += "]";
}

void append_kv_object(std::string& req, const char* key, const char** ks,
                      const char** vs, size_t n) {
    if (!ks || !vs || !n) return;
    req += ",\"";
    req += key;
    req += "\":{";
    for (size_t i = 0; i < n; ++i) {
        if (i) req += ",";
        req += "\"" + json_escape(ks[i] ? ks[i] : "") + "\":\"" +
               json_escape(vs[i] ? vs[i] : "") + "\"";
    }
    req += "}";
}

std::string regex_escape(const char* s) {
    std::string out;
    for (const char* p = s; *p; ++p) {
        if (strchr("\\^$.|?*+()[]{}", *p)) out += '\\';
        out += *p;
    }
    return out;
}

// heap-owned string view for out-params (released by
// yams_mobile_string_view_destroy / the per-family destroy aliases)
yams_mobile_string_view heap_view(const std::string& s) {
    yams_mobile_string_view v;
    char* buf = static_cast<char*>(malloc(s.size() + 1));
    if (buf) memcpy(buf, s.c_str(), s.size() + 1);
    v.data = buf;
    v.length = buf ? s.size() : 0;
    return v;
}

// borrowing view over a handle-owned string
yams_mobile_string_view sv(const std::string* s) {
    yams_mobile_string_view v;
    v.data = s ? s->c_str() : nullptr;
    v.length = s ? s->size() : 0;
    return v;
}

// first integer appearing in a status message ("cleaned 12 rows" -> 12)
uint64_t first_int(const std::string& s) {
    size_t i = s.find_first_of("0123456789");
    if (i == std::string::npos) return 0;
    return strtoull(s.c_str() + i, nullptr, 10);
}

extern "C" {

const char* yams_mobile_last_error_message(void) {
    return g_thread_error.c_str();
}

yams_mobile_version_info yams_mobile_get_version(void) {
    yams_mobile_version_info v;
    v.major = YAMS_MOBILE_API_VERSION_MAJOR;
    v.minor = YAMS_MOBILE_API_VERSION_MINOR;
    v.patch = YAMS_MOBILE_API_VERSION_PATCH;
    return v;
}

yams_mobile_context_config yams_mobile_context_config_default(void) {
    yams_mobile_context_config cfg;
    memset(&cfg, 0, sizeof cfg);
    cfg.struct_size = sizeof(yams_mobile_context_config);
    cfg.version = YAMS_MOBILE_API_VERSION;
    cfg.backend_mode = YAMS_MOBILE_BACKEND_EMBEDDED;
    return cfg;
}

yams_mobile_request_header yams_mobile_request_header_default(void) {
    yams_mobile_request_header h;
    memset(&h, 0, sizeof h);
    h.struct_size = sizeof(yams_mobile_request_header);
    h.version = YAMS_MOBILE_API_VERSION;
    return h;
}

} // extern "C"

// embedded bootstrap: detach a daemon over the working directory (the Python
// CLI owns daemonization; socket convention: <storage>/daemon.sock)
static bool spawn_embedded_daemon(const char* workdir) {
    pid_t pid = fork();
    if (pid < 0) return false;
    if (pid == 0) {
        setsid();
        int devnull = ::open("/dev/null", O_RDWR);
        if (devnull >= 0) {
            dup2(devnull, 0);
            dup2(devnull, 1);
            dup2(devnull, 2);
            if (devnull > 2) ::close(devnull);
        }
        execlp("python3", "python3", "-m", "yams_tpu_torch.cli.main", "--storage",
               workdir, "daemon", "start", (char*)nullptr);
        _exit(127);
    }
    return true;
}

extern "C" {

yams_mobile_status yams_mobile_context_create(
    const yams_mobile_context_config* config,
    yams_mobile_context_t** out_context) {
    if (!out_context) {
        set_tl_error("out_context is required");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    *out_context = nullptr;
    if (!config || config->struct_size < sizeof(yams_mobile_context_config)) {
        set_tl_error("bad context_config (set struct_size = sizeof(config))");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    std::string sock;
    if (config->daemon_socket_path && *config->daemon_socket_path)
        sock = config->daemon_socket_path;
    else if (config->working_directory && *config->working_directory)
        sock = std::string(config->working_directory) + "/daemon.sock";
    else {
        set_tl_error("need working_directory or daemon_socket_path");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    void* conn = yams_mobile_connect(sock.c_str());
    if (!conn && config->backend_mode == YAMS_MOBILE_BACKEND_EMBEDDED &&
        config->working_directory && *config->working_directory) {
        if (!spawn_embedded_daemon(config->working_directory)) {
            set_tl_error("failed to spawn embedded daemon");
            return YAMS_MOBILE_STATUS_INTERNAL_ERROR;
        }
        // the daemon opens its app on the device first (CUDA context, kernel
        // builds at first use): tens of seconds; ping-poll the socket
        for (int i = 0; i < 240 && !conn; ++i) {
            usleep(250 * 1000);
            conn = yams_mobile_connect(sock.c_str());
        }
    }
    if (!conn) {
        set_tl_error("cannot connect to daemon at " + sock);
        return YAMS_MOBILE_STATUS_UNAVAILABLE;
    }
    auto* ctx = new yams_mobile_context_t();
    ctx->conn = conn;
    *out_context = ctx;
    set_tl_error("");
    return YAMS_MOBILE_STATUS_OK;
}

void yams_mobile_context_destroy(yams_mobile_context_t* ctx) {
    if (!ctx) return;
    yams_mobile_disconnect(ctx->conn);
    delete ctx;
}

// result families sharing the opaque handle: borrowing *_result_json +
// *_result_destroy (reference shapes)
#define YM_RESULT_FAMILY(family)                                              \
    yams_mobile_string_view yams_mobile_##family##_result_json(               \
        const yams_mobile_result_t* r) { return sv(r ? &r->json : nullptr); } \
    void yams_mobile_##family##_result_destroy(yams_mobile_result_t* r) {     \
        delete r; }

YM_RESULT_FAMILY(search)
YM_RESULT_FAMILY(grep)
YM_RESULT_FAMILY(list)
YM_RESULT_FAMILY(document_get)
YM_RESULT_FAMILY(delete)
YM_RESULT_FAMILY(metadata)
YM_RESULT_FAMILY(graph_query)
YM_RESULT_FAMILY(update)
YM_RESULT_FAMILY(vector_status)
YM_RESULT_FAMILY(status)

yams_mobile_string_view yams_mobile_search_result_stats_json(
    const yams_mobile_result_t* r) { return sv(r ? &r->stats : nullptr); }
yams_mobile_string_view yams_mobile_grep_result_stats_json(
    const yams_mobile_result_t* r) { return sv(r ? &r->stats : nullptr); }

// typed executes (reference request structs) --------------------------------

yams_mobile_status yams_mobile_search_execute(
    yams_mobile_context_t* ctx, const yams_mobile_search_request* request,
    yams_mobile_search_result_t** out_result) {
    if (!ctx || !request || !request->query) {
        set_tl_error("search_request needs query");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    std::string req = "{\"type\":\"search\"," + jfield("query", request->query) +
                      ",\"limit\":" +
                      std::to_string(request->limit ? request->limit : 10) +
                      ",\"search_type\":\"" +
                      (request->semantic ? "vector" : "hybrid") + "\"";
    append_str_array(req, "tags", request->tags, request->tag_count);
    req += "}";
    return run_request(ctx, req, out_result);
}

yams_mobile_status yams_mobile_grep_execute(
    yams_mobile_context_t* ctx, const yams_mobile_grep_request* request,
    yams_mobile_grep_result_t** out_result) {
    if (!ctx || !request || !request->pattern) {
        set_tl_error("grep_request needs pattern");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    // boundary semantics live server-side (GrepService word_boundary) —
    // rewriting the pattern here duplicated that logic and forced literal
    // patterns through the regex path
    std::string req =
        "{\"type\":\"grep\"," + jfield("pattern", request->pattern) +
        ",\"literal\":" + (request->literal ? "true" : "false") +
        ",\"word_boundary\":" + (request->word_boundary ? "true" : "false") +
        ",\"ignore_case\":" + (request->ignore_case ? "true" : "false") +
        ",\"max_matches\":" +
        std::to_string(request->max_matches ? request->max_matches : 1000) +
        "}";
    return run_request(ctx, req, out_result);
}

yams_mobile_status yams_mobile_store_document(
    yams_mobile_context_t* ctx,
    const yams_mobile_document_store_request* request,
    yams_mobile_string_view* out_hash) {
    if (!ctx || !request || !request->path) {
        set_tl_error("document_store_request needs path");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    std::string req = "{\"type\":\"add_path\"," + jfield("path", request->path);
    append_str_array(req, "tags", request->tags, request->tag_count);
    req += "}";
    MobileResult* r = nullptr;
    yams_mobile_status st = run_request(ctx, req, &r);
    if (st == YAMS_MOBILE_STATUS_OK && out_hash) {
        const JValue* v = jresolve(r, "content_hash");
        if (!v) v = jresolve(r, "sha256_hash");
        *out_hash = heap_view(v && v->kind == JValue::STR ? v->str : "");
    }
    delete r;
    return st;
}

yams_mobile_status yams_mobile_download(
    yams_mobile_context_t* ctx, const yams_mobile_download_request* request,
    yams_mobile_string_view* out_hash) {
    if (!ctx || !request || !request->url) {
        set_tl_error("download_request needs url");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    std::string req = "{\"type\":\"download\"," + jfield("url", request->url);
    append_str_array(req, "tags", request->tags, request->tag_count);
    req += "}";
    MobileResult* r = nullptr;
    yams_mobile_status st = run_request(ctx, req, &r);
    if (st == YAMS_MOBILE_STATUS_OK && out_hash) {
        const JValue* v = jresolve(r, "sha256");
        *out_hash = heap_view(v && v->kind == JValue::STR ? v->str : "");
    }
    delete r;
    return st;
}

yams_mobile_status yams_mobile_update_document(
    yams_mobile_context_t* ctx, const yams_mobile_update_request* request,
    yams_mobile_update_result_t** out_result) {
    if (!ctx || !request || (!request->hash && !request->name)) {
        set_tl_error("update_request needs hash or name");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    const char* sel = request->hash ? request->hash : request->name;
    std::string req = "{\"type\":\"update\"," + jfield("selector", sel);
    append_str_array(req, "add_tags", request->add_tags,
                     request->add_tag_count);
    append_str_array(req, "remove_tags", request->remove_tags,
                     request->remove_tag_count);
    append_kv_object(req, "metadata", request->metadata_keys,
                     request->metadata_values, request->metadata_count);
    req += "}";
    return run_request(ctx, req, out_result);
}

yams_mobile_status yams_mobile_delete_by_name(
    yams_mobile_context_t* ctx, const yams_mobile_delete_request* request,
    yams_mobile_delete_result_t** out_result) {
    if (!ctx || !request ||
        (!request->hash && !request->name && !request->pattern)) {
        set_tl_error("delete_request needs hash, name, or pattern");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    const char* sel = request->hash     ? request->hash
                      : request->name   ? request->name
                                        : request->pattern;
    if (request->dry_run) {
        // resolve without deleting: report what WOULD be removed
        return run_request(
            ctx, "{\"type\":\"get\"," + jfield("selector", sel) + "}",
            out_result);
    }
    return run_request(
        ctx, "{\"type\":\"delete\"," + jfield("selector", sel) + "}",
        out_result);
}

yams_mobile_status yams_mobile_graph_query(
    yams_mobile_context_t* ctx, const yams_mobile_graph_query_request* request,
    yams_mobile_graph_query_result_t** out_result) {
    if (!ctx || !request ||
        (!request->document_hash && !request->document_name)) {
        set_tl_error("graph_query_request needs document_hash or name");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    const char* sel = request->document_hash ? request->document_hash
                                             : request->document_name;
    uint32_t limit = request->limit    ? request->limit
                     : request->max_results ? request->max_results
                                            : 20;
    std::string req = "{\"type\":\"graph_related\"," +
                      jfield("selector", sel) +
                      ",\"limit\":" + std::to_string(limit) + "}";
    return run_request(ctx, req, out_result);
}

yams_mobile_status yams_mobile_remove_document(yams_mobile_context_t* ctx,
                                               const char* document_hash) {
    if (!ctx || !document_hash) {
        set_tl_error("document_hash is required");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    MobileResult* r = nullptr;
    yams_mobile_status st = run_request(
        ctx, "{\"type\":\"delete\"," + jfield("selector", document_hash) + "}",
        &r);
    if (st == YAMS_MOBILE_STATUS_OK) {
        // the daemon reports a no-op delete as {deleted:false}; surface it
        // as NOT_FOUND (reference remove_document semantics)
        const JValue* v = jresolve(r, "deleted");
        if (v && v->kind == JValue::BOOL && !v->b) {
            set_tl_error("document not found: " + std::string(document_hash));
            st = YAMS_MOBILE_STATUS_NOT_FOUND;
        }
    }
    delete r;
    return st;
}

yams_mobile_status yams_mobile_get_metadata(
    yams_mobile_context_t* ctx, const yams_mobile_metadata_request* request,
    yams_mobile_metadata_result_t** out_result) {
    if (!ctx || !request || (!request->document_hash && !request->path)) {
        set_tl_error("metadata_request needs document_hash or path");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    const char* sel =
        request->document_hash ? request->document_hash : request->path;
    return run_request(
        ctx, "{\"type\":\"get\"," + jfield("selector", sel) + "}", out_result);
}

yams_mobile_status yams_mobile_get_vector_status(
    yams_mobile_context_t* ctx,
    const yams_mobile_vector_status_request* request,
    yams_mobile_vector_status_result_t** out_result) {
    (void)request; // warmup is a deprecated no-op (ABI compatibility)
    if (!ctx) return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    return run_request(ctx, "{\"type\":\"stats\",\"detailed\":true}",
                       out_result);
}

yams_mobile_status yams_mobile_list_documents(
    yams_mobile_context_t* ctx, const yams_mobile_list_request* request,
    yams_mobile_list_result_t** out_result) {
    if (!ctx) return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    uint32_t limit = request && request->limit ? request->limit : 100;
    uint32_t offset = request ? request->offset : 0;
    std::string req = "{\"type\":\"list\",\"limit\":" + std::to_string(limit) +
                      ",\"offset\":" + std::to_string(offset);
    if (request && request->pattern)
        req += "," + jfield("pattern", request->pattern);
    req += "}";
    return run_request(ctx, req, out_result);
}

yams_mobile_status yams_mobile_get_document(
    yams_mobile_context_t* ctx,
    const yams_mobile_document_get_request* request,
    yams_mobile_document_get_result_t** out_result) {
    if (!ctx || !request || (!request->document_hash && !request->name)) {
        set_tl_error("document_get_request needs document_hash or name");
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    }
    const char* sel =
        request->document_hash ? request->document_hash : request->name;
    const char* type = (request->include_content ||
                        request->include_extracted_text || request->raw)
                           ? "get_text"
                           : "get";
    return run_request(
        ctx, std::string("{\"type\":\"") + type + "\"," +
                 jfield("selector", sel) + "}",
        out_result);
}

// mobile extensions: repair / diff / cat / restore / model / doctor ----------

yams_mobile_status yams_mobile_repair(
    yams_mobile_context_t* ctx, const yams_mobile_repair_request* request,
    yams_mobile_repair_result** out_result) {
    if (!ctx || !request || !out_result)
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    *out_result = nullptr;
    std::string req = "{\"type\":\"repair\",\"ops\":[";
    bool first = true;
    auto add = [&](const char* op) {
        if (!first) req += ",";
        req += std::string("\"") + op + "\"";
        first = false;
    };
    const char* dry = request->dry_run ? ",\"dry_run\":true" : "";
    if (request->repair_all) {
        req = std::string("{\"type\":\"repair\"") + dry + "}"; // all ops
    } else {
        if (request->repair_embeddings) add("embeddings");
        if (request->repair_fts5) add("fts5");
        if (request->repair_graph) add("graph");
        if (request->repair_orphans) add("orphans");
        req += "]";
        req += dry;
        req += "}";
    }
    MobileResult* r = nullptr;
    yams_mobile_status st = run_request(ctx, req, &r);
    if (st != YAMS_MOBILE_STATUS_OK) {
        delete r;
        return st;
    }
    auto* res = new yams_mobile_repair_result();
    memset(res, 0, sizeof *res);
    res->header = yams_mobile_request_header_default();
    const JValue* root = r->root();
    const JValue* body = root ? root->get("result") : nullptr;
    if (body && body->kind == JValue::OBJ) {
        res->operation_count = (uint32_t)body->obj.size();
        for (const auto& kv : body->obj) {
            if (kv.second.kind != JValue::STR) continue;
            uint64_t n = first_int(kv.second.str);
            if (kv.first == "embeddings") res->embeddings_generated = n;
            else if (kv.first == "fts5") res->fts5_cleaned = n;
            else if (kv.first == "graph") res->graph_repaired = n;
            else if (kv.first == "orphans") res->orphans_removed = n;
        }
    }
    delete r;
    *out_result = res;
    return YAMS_MOBILE_STATUS_OK;
}

void yams_mobile_repair_result_destroy(yams_mobile_repair_result* result) {
    delete result;
}

void yams_mobile_string_view_destroy(yams_mobile_string_view* sv_) {
    if (!sv_) return;
    free((void*)sv_->data);
    sv_->data = nullptr;
    sv_->length = 0;
}

yams_mobile_status yams_mobile_cat(yams_mobile_context_t* ctx,
                                   const yams_mobile_cat_request* request,
                                   yams_mobile_string_view* out_content) {
    if (!ctx || !request || !request->hash || !out_content)
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    MobileResult* r = nullptr;
    yams_mobile_status st = run_request(
        ctx, "{\"type\":\"get_text\"," + jfield("selector", request->hash) +
                 "}",
        &r);
    if (st == YAMS_MOBILE_STATUS_OK) {
        const JValue* v = jresolve(r, "text");
        if (!v) v = jresolve(r, "data");
        *out_content = heap_view(v && v->kind == JValue::STR ? v->str : "");
    }
    delete r;
    return st;
}

void yams_mobile_cat_result_destroy(yams_mobile_string_view* content) {
    yams_mobile_string_view_destroy(content);
}

yams_mobile_status yams_mobile_diff(yams_mobile_context_t* ctx,
                                    const yams_mobile_diff_request* request,
                                    yams_mobile_string_view* out_diff) {
    if (!ctx || !request || !request->hash_a || !out_diff)
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    // fetch both texts, then a prefix/suffix-trimmed line diff (summary tier;
    // the CLI's `diff` does full tree/structural diffs)
    auto fetch = [&](const char* sel, std::string& out) -> yams_mobile_status {
        MobileResult* r = nullptr;
        yams_mobile_status st = run_request(
            ctx, "{\"type\":\"get_text\"," + jfield("selector", sel) + "}",
            &r);
        if (st == YAMS_MOBILE_STATUS_OK) {
            const JValue* v = jresolve(r, "text");
            if (v && v->kind == JValue::STR) out = v->str;
        }
        delete r;
        return st;
    };
    std::string ta, tb;
    yams_mobile_status st = fetch(request->hash_a, ta);
    if (st != YAMS_MOBILE_STATUS_OK) return st;
    if (request->hash_b) {
        st = fetch(request->hash_b, tb);
        if (st != YAMS_MOBILE_STATUS_OK) return st;
    }
    auto split = [](const std::string& s) {
        std::vector<std::string> out;
        size_t start = 0;
        for (size_t i = 0; i <= s.size(); ++i)
            if (i == s.size() || s[i] == '\n') {
                out.push_back(s.substr(start, i - start));
                start = i + 1;
            }
        return out;
    };
    std::vector<std::string> la = split(ta), lb = split(tb);
    size_t pre = 0;
    while (pre < la.size() && pre < lb.size() && la[pre] == lb[pre]) ++pre;
    size_t sa = la.size(), sb = lb.size();
    while (sa > pre && sb > pre && la[sa - 1] == lb[sb - 1]) { --sa; --sb; }
    std::string diff;
    diff += "@@ -" + std::to_string(pre + 1) + "," + std::to_string(sa - pre) +
            " +" + std::to_string(pre + 1) + "," + std::to_string(sb - pre) +
            " @@\n";
    for (size_t i = pre; i < sa; ++i) diff += "-" + la[i] + "\n";
    for (size_t i = pre; i < sb; ++i) diff += "+" + lb[i] + "\n";
    if (sa == pre && sb == pre) diff = "(identical)\n";
    *out_diff = heap_view(diff);
    return YAMS_MOBILE_STATUS_OK;
}

yams_mobile_status yams_mobile_restore(
    yams_mobile_context_t* ctx, const yams_mobile_restore_request* request,
    yams_mobile_string_view* out_summary) {
    if (!ctx || !request || !request->output_directory ||
        (!request->snapshot_id && !request->collection))
        return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    const char* dry = request->dry_run ? ",\"dry_run\":true" : "";
    std::string req;
    if (request->snapshot_id)
        req = "{\"type\":\"restore_snapshot\"," +
              jfield("snapshot_id", request->snapshot_id) + "," +
              jfield("target_dir", request->output_directory) +
              ",\"overwrite\":" + (request->overwrite ? "true" : "false") +
              dry + "}";
    else
        req = "{\"type\":\"restore_collection\"," +
              jfield("collection", request->collection) + "," +
              jfield("target_dir", request->output_directory) +
              ",\"overwrite\":" + (request->overwrite ? "true" : "false") +
              dry + "}";
    MobileResult* r = nullptr;
    yams_mobile_status st = run_request(ctx, req, &r);
    if (st == YAMS_MOBILE_STATUS_OK && out_summary)
        *out_summary = heap_view(r->json);
    delete r;
    return st;
}

void yams_mobile_restore_result_destroy(yams_mobile_string_view* summary) {
    yams_mobile_string_view_destroy(summary);
}

yams_mobile_status yams_mobile_list_models(
    yams_mobile_context_t* ctx, yams_mobile_model_list_result** out_result) {
    if (!ctx || !out_result) return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    *out_result = nullptr;
    MobileResult* r = nullptr;
    yams_mobile_status st =
        run_request(ctx, "{\"type\":\"model_status\"}", &r);
    if (st != YAMS_MOBILE_STATUS_OK) {
        delete r;
        return st;
    }
    struct Row { std::string name, path; uint32_t dim, loaded; };
    std::vector<Row> rows;
    auto push = [&](const JValue* m, uint32_t loaded) {
        if (!m || m->kind != JValue::OBJ) return;
        Row row;
        const JValue* n = m->get("name");
        const JValue* d = m->get("dim");
        const JValue* s = m->get("space_id");
        row.name = n && n->kind == JValue::STR ? n->str : "";
        row.path = s && s->kind == JValue::STR ? s->str : "";
        row.dim = d && d->kind == JValue::NUM ? (uint32_t)d->num : 0;
        row.loaded = loaded;
        rows.push_back(std::move(row));
    };
    push(jresolve(r, "default"), 1);
    if (const JValue* loaded = jresolve(r, "loaded"))
        for (const auto& m : loaded->arr) push(&m, 1);
    if (const JValue* reg = jresolve(r, "registry"))
        for (const auto& m : reg->arr)
            if (m.kind == JValue::STR) {
                bool seen = false;
                for (const auto& row : rows) seen |= (row.name == m.str);
                if (!seen) rows.push_back(Row{m.str, "", 0, 0});
            }
    delete r;
    auto* res = new yams_mobile_model_list_result();
    res->count = (uint32_t)rows.size();
    res->models = res->count ? new yams_mobile_model_info[res->count]
                             : nullptr;
    for (uint32_t i = 0; i < res->count; ++i) {
        res->models[i].name = strdup(rows[i].name.c_str());
        res->models[i].path = strdup(rows[i].path.c_str());
        res->models[i].dim = rows[i].dim;
        res->models[i].is_loaded = rows[i].loaded;
    }
    *out_result = res;
    return YAMS_MOBILE_STATUS_OK;
}

void yams_mobile_model_list_result_destroy(
    yams_mobile_model_list_result* result) {
    if (!result) return;
    for (uint32_t i = 0; i < result->count; ++i) {
        free((void*)result->models[i].name);
        free((void*)result->models[i].path);
    }
    delete[] result->models;
    delete result;
}

yams_mobile_status yams_mobile_set_model(yams_mobile_context_t* ctx,
                                         const char* model_name) {
    if (!ctx || !model_name) return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    MobileResult* r = nullptr;
    yams_mobile_status st = run_request(
        ctx, "{\"type\":\"model_load\"," + jfield("model", model_name) + "}",
        &r);
    delete r;
    return st;
}

yams_mobile_status yams_mobile_get_embedding_info(
    yams_mobile_context_t* ctx, yams_mobile_embedding_info* out_info) {
    if (!ctx || !out_info) return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    memset(out_info, 0, sizeof *out_info);
    MobileResult* r = nullptr;
    yams_mobile_status st =
        run_request(ctx, "{\"type\":\"model_status\"}", &r);
    if (st == YAMS_MOBILE_STATUS_OK) {
        const JValue* d = jresolve(r, "default.dim");
        out_info->available = 1;
        out_info->dim = d && d->kind == JValue::NUM ? (uint32_t)d->num : 0;
    }
    delete r;
    return st;
}

yams_mobile_status yams_mobile_doctor(yams_mobile_context_t* ctx,
                                      yams_mobile_string_view* out_report) {
    if (!ctx || !out_report) return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    MobileResult* r = nullptr;
    yams_mobile_status st = run_request(ctx, "{\"type\":\"doctor\"}", &r);
    if (st == YAMS_MOBILE_STATUS_OK) *out_report = heap_view(r->json);
    delete r;
    return st;
}

void yams_mobile_doctor_result_destroy(yams_mobile_string_view* report) {
    yams_mobile_string_view_destroy(report);
}

// convenience execute retained from the pre-1.0 yams-tpu surface
yams_mobile_status yams_mobile_status_execute(yams_mobile_context_t* ctx,
                                              int detailed,
                                              yams_mobile_result_t** out) {
    if (!ctx) return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    return run_request(ctx,
                       std::string("{\"type\":\"status\",\"detailed\":") +
                           (detailed ? "true" : "false") + "}",
                       out);
}

yams_mobile_status yams_mobile_doctor_execute(yams_mobile_context_t* ctx,
                                              yams_mobile_result_t** out) {
    if (!ctx) return YAMS_MOBILE_STATUS_INVALID_ARGUMENT;
    return run_request(ctx, "{\"type\":\"doctor\"}", out);
}

void yams_mobile_doctor_result_json_destroy(yams_mobile_result_t* r) {
    delete r;
}

// -- field-level typed getters ----------------------------------------------
// (reference: mobile_bindings.h string_view getters — hosts read fields
// without a JSON parser. Generic dotted-path accessors plus per-family
// conveniences. Returned pointers borrow from the handle: valid until the
// matching *_result_destroy; string data is NUL-terminated.)

int yams_mobile_result_ok(yams_mobile_result_t* r) {
    const JValue* v = jresolve(r, "ok");
    return v && v->kind == JValue::BOOL && v->b ? 1 : 0;
}

long long yams_mobile_result_int(yams_mobile_result_t* r, const char* path,
                                 long long dflt) {
    const JValue* v = jresolve(r, path);
    if (!v) return dflt;
    if (v->kind == JValue::NUM) return (long long)v->num;
    if (v->kind == JValue::BOOL) return v->b ? 1 : 0;
    return dflt;
}

double yams_mobile_result_double(yams_mobile_result_t* r, const char* path,
                                 double dflt) {
    const JValue* v = jresolve(r, path);
    return v && v->kind == JValue::NUM ? v->num : dflt;
}

int yams_mobile_result_bool(yams_mobile_result_t* r, const char* path,
                            int dflt) {
    const JValue* v = jresolve(r, path);
    if (!v) return dflt;
    if (v->kind == JValue::BOOL) return v->b ? 1 : 0;
    if (v->kind == JValue::NUM) return v->num != 0.0 ? 1 : 0;
    return dflt;
}

yams_mobile_string_view yams_mobile_result_string(yams_mobile_result_t* r,
                                                  const char* path) {
    const JValue* v = jresolve(r, path);
    return sv(v && v->kind == JValue::STR ? &v->str : nullptr);
}

size_t yams_mobile_result_array_len(yams_mobile_result_t* r,
                                    const char* path) {
    const JValue* v = jresolve(r, path);
    return v && v->kind == JValue::ARR ? v->arr.size() : 0;
}

// object keys at path, written into out[0..cap); returns total key count
size_t yams_mobile_result_keys(yams_mobile_result_t* r, const char* path,
                               yams_mobile_string_view* out, size_t cap) {
    const JValue* v = jresolve(r, path);
    if (!v || v->kind != JValue::OBJ) return 0;
    for (size_t i = 0; i < v->obj.size() && i < cap; ++i)
        out[i] = sv(&v->obj[i].first);
    return v->obj.size();
}

// per-family conveniences over the daemon envelopes:
//   search -> {hits:[{path,score,snippet,title,document_id,...}],total,...}
//   grep   -> {matches:[{path,line,line_number,...}],files_searched,...}
//   list   -> {documents:[{file_path,sha256_hash,file_size,mime_type,...}]}
//   get    -> the document record itself; get_text -> {text}

static const JValue* row_field(yams_mobile_result_t* r, const char* arr_key,
                               size_t i, const char* field) {
    const JValue* a = jresolve(r, arr_key);
    const JValue* row = a ? a->at(i) : nullptr;
    return row ? row->get(field) : nullptr;
}

static yams_mobile_string_view row_str(yams_mobile_result_t* r,
                                       const char* arr_key, size_t i,
                                       const char* field) {
    const JValue* v = row_field(r, arr_key, i, field);
    return sv(v && v->kind == JValue::STR ? &v->str : nullptr);
}

static double row_num(yams_mobile_result_t* r, const char* arr_key, size_t i,
                      const char* field, double dflt) {
    const JValue* v = row_field(r, arr_key, i, field);
    return v && v->kind == JValue::NUM ? v->num : dflt;
}

size_t yams_mobile_search_result_count(yams_mobile_result_t* r) {
    return yams_mobile_result_array_len(r, "hits");
}
yams_mobile_string_view
yams_mobile_search_result_path(yams_mobile_result_t* r, size_t i) {
    return row_str(r, "hits", i, "path");
}
yams_mobile_string_view
yams_mobile_search_result_title(yams_mobile_result_t* r, size_t i) {
    return row_str(r, "hits", i, "title");
}
yams_mobile_string_view
yams_mobile_search_result_snippet(yams_mobile_result_t* r, size_t i) {
    return row_str(r, "hits", i, "snippet");
}
double yams_mobile_search_result_score(yams_mobile_result_t* r, size_t i) {
    return row_num(r, "hits", i, "score", 0.0);
}
long long yams_mobile_search_result_document_id(yams_mobile_result_t* r,
                                                size_t i) {
    return (long long)row_num(r, "hits", i, "document_id", -1.0);
}
long long yams_mobile_search_result_total(yams_mobile_result_t* r) {
    return yams_mobile_result_int(r, "total", 0);
}
double yams_mobile_search_result_duration_ms(yams_mobile_result_t* r) {
    return yams_mobile_result_double(r, "duration_ms", 0.0);
}

size_t yams_mobile_grep_result_count(yams_mobile_result_t* r) {
    return yams_mobile_result_array_len(r, "matches");
}
yams_mobile_string_view
yams_mobile_grep_result_path(yams_mobile_result_t* r, size_t i) {
    return row_str(r, "matches", i, "path");
}
yams_mobile_string_view
yams_mobile_grep_result_line(yams_mobile_result_t* r, size_t i) {
    return row_str(r, "matches", i, "line");
}
long long yams_mobile_grep_result_line_number(yams_mobile_result_t* r,
                                              size_t i) {
    return (long long)row_num(r, "matches", i, "line_number", -1.0);
}
long long yams_mobile_grep_result_files_searched(yams_mobile_result_t* r) {
    return yams_mobile_result_int(r, "files_searched", 0);
}
long long yams_mobile_grep_result_files_matched(yams_mobile_result_t* r) {
    return yams_mobile_result_int(r, "files_matched", 0);
}

size_t yams_mobile_list_result_count(yams_mobile_result_t* r) {
    return yams_mobile_result_array_len(r, "documents");
}
yams_mobile_string_view
yams_mobile_list_result_path(yams_mobile_result_t* r, size_t i) {
    return row_str(r, "documents", i, "file_path");
}
yams_mobile_string_view
yams_mobile_list_result_hash(yams_mobile_result_t* r, size_t i) {
    return row_str(r, "documents", i, "sha256_hash");
}
yams_mobile_string_view
yams_mobile_list_result_mime_type(yams_mobile_result_t* r, size_t i) {
    return row_str(r, "documents", i, "mime_type");
}
long long yams_mobile_list_result_size(yams_mobile_result_t* r, size_t i) {
    return (long long)row_num(r, "documents", i, "file_size", -1.0);
}

yams_mobile_string_view
yams_mobile_document_get_result_path(yams_mobile_result_t* r) {
    return yams_mobile_result_string(r, "file_path");
}
yams_mobile_string_view
yams_mobile_document_get_result_hash(yams_mobile_result_t* r) {
    return yams_mobile_result_string(r, "sha256_hash");
}
yams_mobile_string_view
yams_mobile_document_get_result_mime_type(yams_mobile_result_t* r) {
    return yams_mobile_result_string(r, "mime_type");
}
long long yams_mobile_document_get_result_size(yams_mobile_result_t* r) {
    return yams_mobile_result_int(r, "file_size", -1);
}
yams_mobile_string_view
yams_mobile_document_get_result_content(const yams_mobile_result_t* r) {
    // cat/get_text envelope carries {text}; fall back to {data}
    auto* mr = const_cast<yams_mobile_result_t*>(r);
    yams_mobile_string_view v = yams_mobile_result_string(mr, "text");
    if (!v.data) v = yams_mobile_result_string(mr, "data");
    return v;
}

long long yams_mobile_status_result_document_count(yams_mobile_result_t* r) {
    return yams_mobile_result_int(r, "documents.documents", -1);
}
long long yams_mobile_status_result_block_count(yams_mobile_result_t* r) {
    return yams_mobile_result_int(r, "storage.unique_blocks", -1);
}
yams_mobile_string_view
yams_mobile_status_result_state(yams_mobile_result_t* r) {
    return yams_mobile_result_string(r, "state");
}

} // extern "C"

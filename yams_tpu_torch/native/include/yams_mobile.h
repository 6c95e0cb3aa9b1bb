/* yams_tpu mobile/embedded C ABI — public header.
 *
 * Parity: include/yams/api/mobile_bindings.h in the reference (trvon/yams).
 * Section 1 is SOURCE-COMPATIBLE with the reference's surface: the same
 * typed request structs, status codes, opaque result handles and function
 * signatures, so host code written against the reference's mobile bindings
 * ports by switching the include. Sections 2-3 are yams-tpu extensions:
 * a JSON escape-hatch tier speaking the daemon protocol directly, and
 * field-level typed getters backed by an in-library JSON DOM.
 *
 * Transport: this library speaks the daemon's framed protocol over AF_UNIX
 * (FLAG_JSON payload mode). BACKEND_EMBEDDED spawns a daemon over the
 * working directory on demand; BACKEND_DAEMON attaches to a running one.
 */
#ifndef YAMS_MOBILE_H
#define YAMS_MOBILE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define YAMS_MOBILE_API_VERSION_MAJOR 1U
#define YAMS_MOBILE_API_VERSION_MINOR 0U
#define YAMS_MOBILE_API_VERSION_PATCH 0U

#define YAMS_MOBILE_MAKE_VERSION(major, minor, patch)                        \
    ((((uint32_t)(major)) << 16U) | (((uint32_t)(minor)) << 8U) |            \
     ((uint32_t)(patch)))

#define YAMS_MOBILE_API_VERSION                                              \
    YAMS_MOBILE_MAKE_VERSION(YAMS_MOBILE_API_VERSION_MAJOR,                  \
                             YAMS_MOBILE_API_VERSION_MINOR,                  \
                             YAMS_MOBILE_API_VERSION_PATCH)

/* ------------------------------------------------------------------------ */
/* Section 1 — reference-compatible typed surface                            */
/* ------------------------------------------------------------------------ */

typedef struct yams_mobile_version_info {
    uint16_t major;
    uint16_t minor;
    uint16_t patch;
} yams_mobile_version_info;

typedef enum yams_mobile_status {
    YAMS_MOBILE_STATUS_OK = 0,
    YAMS_MOBILE_STATUS_INVALID_ARGUMENT = 1,
    YAMS_MOBILE_STATUS_NOT_INITIALIZED = 2,
    YAMS_MOBILE_STATUS_INTERNAL_ERROR = 3,
    YAMS_MOBILE_STATUS_TIMEOUT = 4,
    YAMS_MOBILE_STATUS_UNAVAILABLE = 5,
    YAMS_MOBILE_STATUS_NOT_FOUND = 6,
    YAMS_MOBILE_STATUS_UNKNOWN = 255
} yams_mobile_status;

/* Opaque context handle. */
typedef struct yams_mobile_context_t yams_mobile_context_t;

typedef enum yams_mobile_backend_mode {
    YAMS_MOBILE_BACKEND_EMBEDDED = 0, /* spawn a daemon over working_directory */
    YAMS_MOBILE_BACKEND_DAEMON = 1    /* attach to a running daemon socket */
} yams_mobile_backend_mode;

typedef struct yams_mobile_context_config {
    uint32_t struct_size;          /* sizeof(yams_mobile_context_config) */
    uint32_t version;              /* YAMS_MOBILE_API_VERSION */
    uint32_t reserved;             /* 0 */
    const char* working_directory; /* storage root; UTF-8, nullable */
    const char* cache_directory;   /* optional cache override (unused) */
    const char* telemetry_sink;    /* "console"|"stderr"|"noop"|"file:/p" */
    uint32_t max_worker_threads;   /* 0 => auto */
    uint32_t flags;                /* reserved */
    uint32_t backend_mode;         /* yams_mobile_backend_mode */
    const char* daemon_socket_path; /* socket override (daemon mode) */
} yams_mobile_context_config;

typedef struct yams_mobile_request_header {
    uint32_t struct_size;       /* sizeof(yams_mobile_request_header) */
    uint32_t version;           /* YAMS_MOBILE_API_VERSION */
    uint32_t flags;             /* 0 */
    const char* correlation_id; /* optional tracing id */
    uint32_t timeout_ms;        /* 0 => default */
} yams_mobile_request_header;

/* UTF-8 slice. Views returned by *_result_* getters borrow from the result
 * handle (valid until its destroy); views returned through out-params
 * (store/download/cat/diff/restore/doctor) are heap-owned — release with
 * the matching destroy function or yams_mobile_string_view_destroy. */
typedef struct yams_mobile_string_view {
    const char* data;
    size_t length;
} yams_mobile_string_view;

typedef struct yams_mobile_grep_request {
    yams_mobile_request_header header;
    const char* pattern;
    uint8_t literal;
    uint8_t ignore_case;
    uint8_t word_boundary;
    uint32_t max_matches;
} yams_mobile_grep_request;

typedef struct yams_mobile_result_t yams_mobile_result_t;
/* Per-family result handles all share one underlying representation; the
 * family aliases keep reference-compatible spellings. */
typedef struct yams_mobile_result_t yams_mobile_grep_result_t;
typedef struct yams_mobile_result_t yams_mobile_search_result_t;
typedef struct yams_mobile_result_t yams_mobile_metadata_result_t;
typedef struct yams_mobile_result_t yams_mobile_vector_status_result_t;
typedef struct yams_mobile_result_t yams_mobile_list_result_t;
typedef struct yams_mobile_result_t yams_mobile_update_result_t;
typedef struct yams_mobile_result_t yams_mobile_delete_result_t;
typedef struct yams_mobile_result_t yams_mobile_graph_query_result_t;
typedef struct yams_mobile_result_t yams_mobile_document_get_result_t;

typedef struct yams_mobile_search_request {
    yams_mobile_request_header header;
    const char* query;
    uint32_t limit;
    const char** tags;
    size_t tag_count;
    uint8_t paths_only;
    uint8_t semantic;
} yams_mobile_search_request;

typedef struct yams_mobile_document_store_request {
    yams_mobile_request_header header;
    const char* path;
    const char** tags;
    size_t tag_count;
    uint8_t sync_now;
} yams_mobile_document_store_request;

typedef struct yams_mobile_download_request {
    yams_mobile_request_header header;
    const char* url;
    const char** tags;
    size_t tag_count;
    const char** metadata_keys;
    const char** metadata_values;
    size_t metadata_count;
    uint32_t timeout_ms;
    uint8_t overwrite;
} yams_mobile_download_request;

typedef struct yams_mobile_metadata_request {
    yams_mobile_request_header header;
    const char* document_hash;
    const char* path;
} yams_mobile_metadata_request;

typedef struct yams_mobile_vector_status_request {
    yams_mobile_request_header header;
    uint8_t warmup; /* deprecated no-op, ABI compatibility */
} yams_mobile_vector_status_request;

typedef struct yams_mobile_list_request {
    yams_mobile_request_header header;
    const char* pattern;
    const char** tags;
    size_t tag_count;
    uint32_t limit;
    uint32_t offset;
    uint8_t match_all_tags;
    uint8_t paths_only;
} yams_mobile_list_request;

typedef struct yams_mobile_update_request {
    yams_mobile_request_header header;
    const char* hash;
    const char* name;
    const char** add_tags;
    size_t add_tag_count;
    const char** remove_tags;
    size_t remove_tag_count;
    const char** metadata_keys;
    const char** metadata_values;
    size_t metadata_count;
} yams_mobile_update_request;

typedef struct yams_mobile_delete_request {
    yams_mobile_request_header header;
    const char* hash;
    const char* name;
    const char* pattern;
    uint8_t dry_run;
} yams_mobile_delete_request;

typedef struct yams_mobile_graph_query_request {
    yams_mobile_request_header header;
    const char* document_hash;
    const char* document_name;
    const char* snapshot_id;
    int64_t node_id;
    const char** relation_filters;
    size_t relation_filter_count;
    int32_t max_depth;
    uint32_t max_results;
    uint32_t offset;
    uint32_t limit;
    uint8_t reverse_traversal;
    uint8_t include_edge_properties;
    uint8_t include_node_properties;
} yams_mobile_graph_query_request;

typedef struct yams_mobile_document_get_request {
    yams_mobile_request_header header;
    const char* document_hash;
    const char* name;
    uint8_t metadata_only;
    uint8_t include_content;
    uint8_t include_extracted_text;
    uint8_t raw;
    uint8_t latest;
    uint8_t oldest;
    uint64_t max_bytes;
} yams_mobile_document_get_request;

/* Mobile extensions (repair / doctor / diff / cat / restore / model). */

typedef struct yams_mobile_repair_request {
    yams_mobile_request_header header;
    const char* embedding_model;
    uint32_t repair_embeddings : 1;
    uint32_t repair_fts5 : 1;
    uint32_t repair_graph : 1;
    uint32_t repair_orphans : 1;
    uint32_t repair_all : 1;
    uint32_t dry_run : 1;
    uint32_t reserved : 26;
    int32_t max_retries;
} yams_mobile_repair_request;

typedef struct yams_mobile_repair_result {
    yams_mobile_request_header header;
    uint64_t embeddings_generated;
    uint64_t embeddings_skipped;
    uint64_t fts5_cleaned;
    uint64_t graph_repaired;
    uint64_t orphans_removed;
    uint32_t operation_count;
} yams_mobile_repair_result;

typedef struct yams_mobile_diff_request {
    yams_mobile_request_header header;
    const char* hash_a;
    const char* hash_b; /* NULL => latest snapshot diff */
} yams_mobile_diff_request;

typedef struct yams_mobile_cat_request {
    yams_mobile_request_header header;
    const char* hash;
} yams_mobile_cat_request;

typedef struct yams_mobile_restore_request {
    yams_mobile_request_header header;
    const char* collection;
    const char* snapshot_id;
    const char* output_directory;
    uint32_t overwrite : 1;
    uint32_t dry_run : 1;
    uint32_t reserved : 30;
} yams_mobile_restore_request;

typedef struct yams_mobile_model_info {
    const char* name;
    const char* path;
    uint32_t dim;
    uint32_t is_loaded;
} yams_mobile_model_info;

typedef struct yams_mobile_model_list_result {
    yams_mobile_model_info* models;
    uint32_t count;
} yams_mobile_model_list_result;

typedef struct yams_mobile_embedding_info {
    uint32_t available : 1;
    uint32_t dim;
    uint32_t reserved;
} yams_mobile_embedding_info;

/* Defaults (exported functions rather than header-inline so ctypes/FFI
 * hosts can call them too; call syntax matches the reference). */
yams_mobile_context_config yams_mobile_context_config_default(void);
yams_mobile_request_header yams_mobile_request_header_default(void);

yams_mobile_version_info yams_mobile_get_version(void);

yams_mobile_status yams_mobile_context_create(
    const yams_mobile_context_config* config,
    yams_mobile_context_t** out_context);
void yams_mobile_context_destroy(yams_mobile_context_t* ctx);

yams_mobile_status yams_mobile_grep_execute(
    yams_mobile_context_t* ctx, const yams_mobile_grep_request* request,
    yams_mobile_grep_result_t** out_result);
void yams_mobile_grep_result_destroy(yams_mobile_grep_result_t* result);

yams_mobile_status yams_mobile_search_execute(
    yams_mobile_context_t* ctx, const yams_mobile_search_request* request,
    yams_mobile_search_result_t** out_result);
void yams_mobile_search_result_destroy(yams_mobile_search_result_t* result);

yams_mobile_status yams_mobile_store_document(
    yams_mobile_context_t* ctx,
    const yams_mobile_document_store_request* request,
    yams_mobile_string_view* out_hash);

yams_mobile_status yams_mobile_download(
    yams_mobile_context_t* ctx, const yams_mobile_download_request* request,
    yams_mobile_string_view* out_hash);

yams_mobile_status yams_mobile_update_document(
    yams_mobile_context_t* ctx, const yams_mobile_update_request* request,
    yams_mobile_update_result_t** out_result);
void yams_mobile_update_result_destroy(yams_mobile_update_result_t* result);
yams_mobile_string_view yams_mobile_update_result_json(
    const yams_mobile_update_result_t* result);

yams_mobile_status yams_mobile_delete_by_name(
    yams_mobile_context_t* ctx, const yams_mobile_delete_request* request,
    yams_mobile_delete_result_t** out_result);
void yams_mobile_delete_result_destroy(yams_mobile_delete_result_t* result);
yams_mobile_string_view yams_mobile_delete_result_json(
    const yams_mobile_delete_result_t* result);

yams_mobile_status yams_mobile_graph_query(
    yams_mobile_context_t* ctx, const yams_mobile_graph_query_request* request,
    yams_mobile_graph_query_result_t** out_result);
void yams_mobile_graph_query_result_destroy(
    yams_mobile_graph_query_result_t* result);
yams_mobile_string_view yams_mobile_graph_query_result_json(
    const yams_mobile_graph_query_result_t* result);

yams_mobile_status yams_mobile_remove_document(yams_mobile_context_t* ctx,
                                               const char* document_hash);

yams_mobile_status yams_mobile_get_metadata(
    yams_mobile_context_t* ctx, const yams_mobile_metadata_request* request,
    yams_mobile_metadata_result_t** out_result);
void yams_mobile_metadata_result_destroy(yams_mobile_metadata_result_t* result);
yams_mobile_string_view yams_mobile_metadata_result_json(
    const yams_mobile_metadata_result_t* result);

yams_mobile_status yams_mobile_get_vector_status(
    yams_mobile_context_t* ctx,
    const yams_mobile_vector_status_request* request,
    yams_mobile_vector_status_result_t** out_result);
void yams_mobile_vector_status_result_destroy(
    yams_mobile_vector_status_result_t* result);
yams_mobile_string_view yams_mobile_vector_status_result_json(
    const yams_mobile_vector_status_result_t* result);

yams_mobile_string_view yams_mobile_grep_result_stats_json(
    const yams_mobile_grep_result_t* result);
yams_mobile_string_view yams_mobile_search_result_stats_json(
    const yams_mobile_search_result_t* result);
yams_mobile_string_view yams_mobile_search_result_json(
    const yams_mobile_search_result_t* result);
yams_mobile_string_view yams_mobile_grep_result_json(
    const yams_mobile_grep_result_t* result);

yams_mobile_status yams_mobile_list_documents(
    yams_mobile_context_t* ctx, const yams_mobile_list_request* request,
    yams_mobile_list_result_t** out_result);
void yams_mobile_list_result_destroy(yams_mobile_list_result_t* result);
yams_mobile_string_view yams_mobile_list_result_json(
    const yams_mobile_list_result_t* result);

yams_mobile_status yams_mobile_get_document(
    yams_mobile_context_t* ctx,
    const yams_mobile_document_get_request* request,
    yams_mobile_document_get_result_t** out_result);
void yams_mobile_document_get_result_destroy(
    yams_mobile_document_get_result_t* result);
yams_mobile_string_view yams_mobile_document_get_result_json(
    const yams_mobile_document_get_result_t* result);
yams_mobile_string_view yams_mobile_document_get_result_content(
    const yams_mobile_document_get_result_t* result);

/* Thread-local extended error for the last API call on this thread; the
 * pointer stays valid until the next API call on the same thread. */
const char* yams_mobile_last_error_message(void);

yams_mobile_status yams_mobile_repair(yams_mobile_context_t* ctx,
                                      const yams_mobile_repair_request* request,
                                      yams_mobile_repair_result** out_result);
void yams_mobile_repair_result_destroy(yams_mobile_repair_result* result);

yams_mobile_status yams_mobile_diff(yams_mobile_context_t* ctx,
                                    const yams_mobile_diff_request* request,
                                    yams_mobile_string_view* out_diff);
void yams_mobile_string_view_destroy(yams_mobile_string_view* sv);

yams_mobile_status yams_mobile_cat(yams_mobile_context_t* ctx,
                                   const yams_mobile_cat_request* request,
                                   yams_mobile_string_view* out_content);
void yams_mobile_cat_result_destroy(yams_mobile_string_view* content);

yams_mobile_status yams_mobile_restore(
    yams_mobile_context_t* ctx, const yams_mobile_restore_request* request,
    yams_mobile_string_view* out_summary);
void yams_mobile_restore_result_destroy(yams_mobile_string_view* summary);

yams_mobile_status yams_mobile_list_models(
    yams_mobile_context_t* ctx, yams_mobile_model_list_result** out_result);
void yams_mobile_model_list_result_destroy(
    yams_mobile_model_list_result* result);

yams_mobile_status yams_mobile_set_model(yams_mobile_context_t* ctx,
                                         const char* model_name);
yams_mobile_status yams_mobile_get_embedding_info(
    yams_mobile_context_t* ctx, yams_mobile_embedding_info* out_info);

yams_mobile_status yams_mobile_doctor(yams_mobile_context_t* ctx,
                                      yams_mobile_string_view* out_report);
void yams_mobile_doctor_result_destroy(yams_mobile_string_view* report);

/* ------------------------------------------------------------------------ */
/* Section 2 — JSON escape-hatch tier (yams-tpu extension)                   */
/* Raw daemon-protocol access: every call returns a malloc'd JSON string     */
/* released with yams_mobile_free. Connection handles are independent of     */
/* Section 1 contexts.                                                       */
/* ------------------------------------------------------------------------ */

int yams_mobile_abi_version(void);
void* yams_mobile_connect(const char* socket_path);
void yams_mobile_disconnect(void* handle);
void yams_mobile_free(char* s);
char* yams_mobile_request(void* handle, const char* json_request);
char* yams_mobile_ping(void* handle);
char* yams_mobile_status_json(void* handle, int detailed);
char* yams_mobile_search(void* handle, const char* query, int limit,
                         const char* search_type);
char* yams_mobile_grep(void* handle, const char* pattern, int max_matches);
char* yams_mobile_add_text(void* handle, const char* name,
                           const char* content);
char* yams_mobile_get_text(void* handle, const char* selector);
char* yams_mobile_get_metadata_json(void* handle, const char* selector);
char* yams_mobile_delete(void* handle, const char* selector);
char* yams_mobile_list(void* handle, int limit);
char* yams_mobile_update_metadata(void* handle, const char* selector,
                                  const char* key, const char* value);
char* yams_mobile_graph_explore(void* handle, const char* query, int limit);
char* yams_mobile_graph_related(void* handle, const char* selector,
                                int limit);
char* yams_mobile_suggest_context(void* handle, const char* query, int limit);
char* yams_mobile_session(void* handle, const char* op, const char* arg);
char* yams_mobile_repair_json(void* handle, const char* ops_csv);
char* yams_mobile_doctor_json(void* handle);
char* yams_mobile_checkpoint(void* handle);
char* yams_mobile_embed(void* handle, const char* text);
char* yams_mobile_download_json(void* handle, const char* url);

/* ------------------------------------------------------------------------ */
/* Section 3 — field-level typed getters (yams-tpu extension)                */
/* Read response fields without a JSON parser. Views borrow from the result  */
/* handle (valid until its destroy; data is NUL-terminated).                 */
/* ------------------------------------------------------------------------ */

int yams_mobile_result_ok(yams_mobile_result_t* r);
long long yams_mobile_result_int(yams_mobile_result_t* r, const char* path,
                                 long long dflt);
double yams_mobile_result_double(yams_mobile_result_t* r, const char* path,
                                 double dflt);
int yams_mobile_result_bool(yams_mobile_result_t* r, const char* path,
                            int dflt);
yams_mobile_string_view yams_mobile_result_string(yams_mobile_result_t* r,
                                                  const char* path);
size_t yams_mobile_result_array_len(yams_mobile_result_t* r,
                                    const char* path);
size_t yams_mobile_result_keys(yams_mobile_result_t* r, const char* path,
                               yams_mobile_string_view* out, size_t cap);

size_t yams_mobile_search_result_count(yams_mobile_result_t* r);
yams_mobile_string_view yams_mobile_search_result_path(
    yams_mobile_result_t* r, size_t i);
yams_mobile_string_view yams_mobile_search_result_title(
    yams_mobile_result_t* r, size_t i);
yams_mobile_string_view yams_mobile_search_result_snippet(
    yams_mobile_result_t* r, size_t i);
double yams_mobile_search_result_score(yams_mobile_result_t* r, size_t i);
long long yams_mobile_search_result_document_id(yams_mobile_result_t* r,
                                                size_t i);
long long yams_mobile_search_result_total(yams_mobile_result_t* r);
double yams_mobile_search_result_duration_ms(yams_mobile_result_t* r);

size_t yams_mobile_grep_result_count(yams_mobile_result_t* r);
yams_mobile_string_view yams_mobile_grep_result_path(yams_mobile_result_t* r,
                                                     size_t i);
yams_mobile_string_view yams_mobile_grep_result_line(yams_mobile_result_t* r,
                                                     size_t i);
long long yams_mobile_grep_result_line_number(yams_mobile_result_t* r,
                                              size_t i);
long long yams_mobile_grep_result_files_searched(yams_mobile_result_t* r);
long long yams_mobile_grep_result_files_matched(yams_mobile_result_t* r);

size_t yams_mobile_list_result_count(yams_mobile_result_t* r);
yams_mobile_string_view yams_mobile_list_result_path(yams_mobile_result_t* r,
                                                     size_t i);
yams_mobile_string_view yams_mobile_list_result_hash(yams_mobile_result_t* r,
                                                     size_t i);
yams_mobile_string_view yams_mobile_list_result_mime_type(
    yams_mobile_result_t* r, size_t i);
long long yams_mobile_list_result_size(yams_mobile_result_t* r, size_t i);

yams_mobile_string_view yams_mobile_document_get_result_path(
    yams_mobile_result_t* r);
yams_mobile_string_view yams_mobile_document_get_result_hash(
    yams_mobile_result_t* r);
yams_mobile_string_view yams_mobile_document_get_result_mime_type(
    yams_mobile_result_t* r);
long long yams_mobile_document_get_result_size(yams_mobile_result_t* r);

long long yams_mobile_status_result_document_count(yams_mobile_result_t* r);
long long yams_mobile_status_result_block_count(yams_mobile_result_t* r);
yams_mobile_string_view yams_mobile_status_result_state(
    yams_mobile_result_t* r);

/* Convenience executes retained from the pre-1.0 yams-tpu surface. */
yams_mobile_status yams_mobile_status_execute(yams_mobile_context_t* ctx,
                                              int detailed,
                                              yams_mobile_result_t** out);
void yams_mobile_status_result_destroy(yams_mobile_result_t* r);
yams_mobile_status yams_mobile_doctor_execute(yams_mobile_context_t* ctx,
                                              yams_mobile_result_t** out);
void yams_mobile_doctor_result_json_destroy(yams_mobile_result_t* r);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* YAMS_MOBILE_H */

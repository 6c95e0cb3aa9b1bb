/* yams_tpu native plugin ABI — C plugins loaded via dlopen.
 *
 * Parity: the upstream include/yams/plugins/abi.h (lifecycle symbols,
 * version negotiation, health) and content_extractor_v1.h /
 * model_provider_v1.h / entity_extractor_v2.h (typed vtables negotiated by
 * (id, version) through yams_plugin_get_interface). WIT contracts for the
 * same interfaces live at docs/spec/wit/*.wit.
 *
 * A plugin is a shared library exporting the yams_plugin_* lifecycle symbols
 * below. The host (yams_tpu.plugins.native_host) dlopens trust-listed .so
 * files, checks the ABI version, calls init with a JSON config, negotiates
 * typed interfaces, and wires them into the embedding / extraction / graph
 * registries exactly like Python plugins.
 *
 * Memory ownership: any pointer returned by the plugin is owned by the
 * plugin and released through the matching free_* function on the same
 * vtable. The host never calls free() on plugin memory.
 */
#pragma once

#include <stdbool.h>
#include <stddef.h>
#include <stdint.h>

#if defined(__GNUC__) || defined(__clang__)
#define YAMS_PLUGIN_API __attribute__((visibility("default")))
#else
#define YAMS_PLUGIN_API
#endif

#ifdef __cplusplus
extern "C" {
#endif

#define YAMS_PLUGIN_ABI_VERSION 1

#define YAMS_PLUGIN_OK 0
#define YAMS_PLUGIN_ERR_INCOMPATIBLE -1
#define YAMS_PLUGIN_ERR_NOT_FOUND -2
#define YAMS_PLUGIN_ERR_INIT_FAILED -3
#define YAMS_PLUGIN_ERR_INVALID -4

/* -- lifecycle (every plugin must export all of these) -------------------- */

YAMS_PLUGIN_API int yams_plugin_get_abi_version(void);
YAMS_PLUGIN_API const char* yams_plugin_get_name(void);
YAMS_PLUGIN_API const char* yams_plugin_get_version(void);
/* JSON: {"name","version","description","interfaces":[{"id","version"}]} */
YAMS_PLUGIN_API const char* yams_plugin_get_manifest_json(void);
YAMS_PLUGIN_API int yams_plugin_init(const char* config_json,
                                     const void* host_context);
YAMS_PLUGIN_API void yams_plugin_shutdown(void);
/* Negotiate a typed vtable; *out_iface points at plugin-owned static data. */
YAMS_PLUGIN_API int yams_plugin_get_interface(const char* iface_id,
                                              uint32_t version,
                                              void** out_iface);
/* *out_json: malloc'd {"status":"ok"|...}; host frees with free(). */
YAMS_PLUGIN_API int yams_plugin_get_health_json(char** out_json);

/* -- content_extractor_v1 ------------------------------------------------- */

#define YAMS_IFACE_CONTENT_EXTRACTOR_V1_ID "content_extractor_v1"
#define YAMS_IFACE_CONTENT_EXTRACTOR_V1_VERSION 1u

typedef struct {
    char* text;  /* extracted UTF-8 text; NULL on failure */
    char* title; /* optional document title; may be NULL */
    char* error; /* NULL on success, message on failure */
} yams_extraction_result_t;

typedef struct {
    uint32_t abi_version;
    /* True when this extractor handles (mime_type, extension). */
    bool (*supports)(const char* mime_type, const char* extension);
    /* 0 on success; *result freed with free_result(). */
    int (*extract)(const uint8_t* content, size_t content_len,
                   const char* mime_type, yams_extraction_result_t** result);
    void (*free_result)(yams_extraction_result_t* result);
} yams_content_extractor_v1;

/* -- model_provider_v1 ---------------------------------------------------- */

#define YAMS_IFACE_MODEL_PROVIDER_V1_ID "model_provider_v1"
#define YAMS_IFACE_MODEL_PROVIDER_V1_VERSION 1u

typedef struct {
    uint32_t abi_version;
    void* self; /* opaque plugin context, passed to every call */
    const char* (*model_id)(void* self);
    uint32_t (*dim)(void* self);
    /* Embed n NUL-terminated UTF-8 texts into out[n*dim] row-major floats.
     * Rows need not be normalized; the host L2-normalizes. 0 on success. */
    int (*embed)(void* self, const char* const* texts, size_t n, float* out);
} yams_model_provider_v1;

/* -- entity_extractor_v1 -------------------------------------------------- */

#define YAMS_IFACE_ENTITY_EXTRACTOR_V1_ID "entity_extractor_v1"
#define YAMS_IFACE_ENTITY_EXTRACTOR_V1_VERSION 1u

typedef struct {
    uint32_t abi_version;
    void* self;
    /* malloc'd JSON [["entity","type",confidence], ...]; NULL on failure.
     * Freed with free_json(). */
    char* (*extract_entities_json)(void* self, const char* text);
    void (*free_json)(void* self, char* ptr);
} yams_entity_extractor_v1;

#ifdef __cplusplus
}
#endif

"""ctypes shapes of the mobile C ABI (`native/include/yams_mobile.h`).

The structs a C host fills in (request headers, the context config, the
typed requests and results) and the signature of every function that
`native.mobile_library()` binds: the JSON escape hatch (section 2), the
reference-shaped typed surface (section 1) and the field-level getters
(section 3). A Python caller uses these where a C host includes the header.
"""

from __future__ import annotations

import ctypes

u8, u16, u32, u64 = ctypes.c_uint8, ctypes.c_uint16, ctypes.c_uint32, ctypes.c_uint64
sz = ctypes.c_size_t
cp = ctypes.c_char_p
cpp = ctypes.POINTER(ctypes.c_char_p)
vp = ctypes.c_void_p
out_t = ctypes.POINTER(ctypes.c_void_p)

BACKEND_EMBEDDED, BACKEND_DAEMON = 0, 1


class RequestHeader(ctypes.Structure):
    _fields_ = [("struct_size", u32), ("version", u32), ("flags", u32),
                ("correlation_id", cp), ("timeout_ms", u32)]


class ContextConfig(ctypes.Structure):
    _fields_ = [("struct_size", u32), ("version", u32), ("reserved", u32),
                ("working_directory", cp), ("cache_directory", cp),
                ("telemetry_sink", cp), ("max_worker_threads", u32),
                ("flags", u32), ("backend_mode", u32),
                ("daemon_socket_path", cp)]


class VersionInfo(ctypes.Structure):
    _fields_ = [("major", u16), ("minor", u16), ("patch", u16)]


class StringView(ctypes.Structure):
    _fields_ = [("data", vp), ("length", sz)]

    def text(self) -> str:
        return ctypes.string_at(self.data, self.length).decode() if self.data else ""


class SearchRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("query", cp), ("limit", u32),
                ("tags", cpp), ("tag_count", sz), ("paths_only", u8),
                ("semantic", u8)]


class GrepRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("pattern", cp), ("literal", u8),
                ("ignore_case", u8), ("word_boundary", u8),
                ("max_matches", u32)]


class DocumentStoreRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("path", cp), ("tags", cpp),
                ("tag_count", sz), ("sync_now", u8)]


class DownloadRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("url", cp), ("tags", cpp),
                ("tag_count", sz), ("metadata_keys", cpp),
                ("metadata_values", cpp), ("metadata_count", sz),
                ("timeout_ms", u32), ("overwrite", u8)]


class ListRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("pattern", cp), ("tags", cpp),
                ("tag_count", sz), ("limit", u32), ("offset", u32),
                ("match_all_tags", u8), ("paths_only", u8)]


class DocumentGetRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("document_hash", cp),
                ("name", cp), ("metadata_only", u8), ("include_content", u8),
                ("include_extracted_text", u8), ("raw", u8), ("latest", u8),
                ("oldest", u8), ("max_bytes", u64)]


class UpdateRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("hash", cp), ("name", cp),
                ("add_tags", cpp), ("add_tag_count", sz),
                ("remove_tags", cpp), ("remove_tag_count", sz),
                ("metadata_keys", cpp), ("metadata_values", cpp),
                ("metadata_count", sz)]


class DeleteRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("hash", cp), ("name", cp),
                ("pattern", cp), ("dry_run", u8)]


class GraphQueryRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("document_hash", cp),
                ("document_name", cp), ("snapshot_id", cp),
                ("node_id", ctypes.c_int64), ("relation_filters", cpp),
                ("relation_filter_count", sz),
                ("max_depth", ctypes.c_int32), ("max_results", u32),
                ("offset", u32), ("limit", u32), ("reverse_traversal", u8),
                ("include_edge_properties", u8),
                ("include_node_properties", u8)]


class MetadataRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("document_hash", cp),
                ("path", cp)]


class VectorStatusRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("warmup", u8)]


class CatRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("hash", cp)]


class DiffRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("hash_a", cp), ("hash_b", cp)]


class RepairRequest(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("embedding_model", cp),
                ("repair_embeddings", u32, 1), ("repair_fts5", u32, 1),
                ("repair_graph", u32, 1), ("repair_orphans", u32, 1),
                ("repair_all", u32, 1), ("dry_run", u32, 1),
                ("reserved", u32, 26), ("max_retries", ctypes.c_int32)]


class RepairResult(ctypes.Structure):
    _fields_ = [("header", RequestHeader), ("embeddings_generated", u64),
                ("embeddings_skipped", u64), ("fts5_cleaned", u64),
                ("graph_repaired", u64), ("orphans_removed", u64),
                ("operation_count", u32)]


class ModelInfo(ctypes.Structure):
    _fields_ = [("name", cp), ("path", cp), ("dim", u32), ("is_loaded", u32)]


class ModelListResult(ctypes.Structure):
    _fields_ = [("models", ctypes.POINTER(ModelInfo)), ("count", u32)]


class EmbeddingInfo(ctypes.Structure):
    _fields_ = [("available", u32, 1), ("dim", u32), ("reserved", u32)]


_P = ctypes.POINTER
_ll, _dbl, _int = ctypes.c_longlong, ctypes.c_double, ctypes.c_int

# symbol -> (restype, argtypes)
SIGNATURES: dict = {
    "ytn_abi_version": (_int, []),
    "ytn_crc32": (u32, [cp, sz, u32]),
    # section 2: JSON escape hatch, malloc'd strings freed by yams_mobile_free
    "yams_mobile_abi_version": (_int, []),
    "yams_mobile_connect": (vp, [cp]),
    "yams_mobile_disconnect": (None, [vp]),
    "yams_mobile_free": (None, [vp]),
    "yams_mobile_ping": (vp, [vp]),
    "yams_mobile_request": (vp, [vp, cp]),
    "yams_mobile_status_json": (vp, [vp, _int]),
    "yams_mobile_search": (vp, [vp, cp, _int, cp]),
    "yams_mobile_grep": (vp, [vp, cp, _int]),
    "yams_mobile_add_text": (vp, [vp, cp, cp]),
    "yams_mobile_get_text": (vp, [vp, cp]),
    "yams_mobile_get_metadata_json": (vp, [vp, cp]),
    "yams_mobile_delete": (vp, [vp, cp]),
    "yams_mobile_list": (vp, [vp, _int]),
    "yams_mobile_update_metadata": (vp, [vp, cp, cp, cp]),
    "yams_mobile_graph_explore": (vp, [vp, cp, _int]),
    "yams_mobile_graph_related": (vp, [vp, cp, _int]),
    "yams_mobile_suggest_context": (vp, [vp, cp, _int]),
    "yams_mobile_session": (vp, [vp, cp, cp]),
    "yams_mobile_repair_json": (vp, [vp, cp]),
    "yams_mobile_doctor_json": (vp, [vp]),
    "yams_mobile_checkpoint": (vp, [vp]),
    "yams_mobile_embed": (vp, [vp, cp]),
    "yams_mobile_download_json": (vp, [vp, cp]),
    # section 1: the reference-shaped typed surface
    "yams_mobile_context_config_default": (ContextConfig, []),
    "yams_mobile_request_header_default": (RequestHeader, []),
    "yams_mobile_get_version": (VersionInfo, []),
    "yams_mobile_context_create": (_int, [_P(ContextConfig), out_t]),
    "yams_mobile_context_destroy": (None, [vp]),
    "yams_mobile_last_error_message": (cp, []),
    "yams_mobile_search_execute": (_int, [vp, _P(SearchRequest), out_t]),
    "yams_mobile_grep_execute": (_int, [vp, _P(GrepRequest), out_t]),
    "yams_mobile_list_documents": (_int, [vp, _P(ListRequest), out_t]),
    "yams_mobile_get_document": (_int, [vp, _P(DocumentGetRequest), out_t]),
    "yams_mobile_update_document": (_int, [vp, _P(UpdateRequest), out_t]),
    "yams_mobile_delete_by_name": (_int, [vp, _P(DeleteRequest), out_t]),
    "yams_mobile_graph_query": (_int, [vp, _P(GraphQueryRequest), out_t]),
    "yams_mobile_get_metadata": (_int, [vp, _P(MetadataRequest), out_t]),
    "yams_mobile_get_vector_status": (_int, [vp, _P(VectorStatusRequest), out_t]),
    "yams_mobile_store_document": (_int, [vp, _P(DocumentStoreRequest), _P(StringView)]),
    "yams_mobile_download": (_int, [vp, _P(DownloadRequest), _P(StringView)]),
    "yams_mobile_cat": (_int, [vp, _P(CatRequest), _P(StringView)]),
    "yams_mobile_diff": (_int, [vp, _P(DiffRequest), _P(StringView)]),
    "yams_mobile_doctor": (_int, [vp, _P(StringView)]),
    "yams_mobile_repair": (_int, [vp, _P(RepairRequest), _P(_P(RepairResult))]),
    "yams_mobile_repair_result_destroy": (None, [_P(RepairResult)]),
    "yams_mobile_remove_document": (_int, [vp, cp]),
    "yams_mobile_set_model": (_int, [vp, cp]),
    "yams_mobile_get_embedding_info": (_int, [vp, _P(EmbeddingInfo)]),
    "yams_mobile_list_models": (_int, [vp, _P(_P(ModelListResult))]),
    "yams_mobile_model_list_result_destroy": (None, [_P(ModelListResult)]),
    "yams_mobile_string_view_destroy": (None, [_P(StringView)]),
    "yams_mobile_cat_result_destroy": (None, [_P(StringView)]),
    "yams_mobile_doctor_result_destroy": (None, [_P(StringView)]),
    "yams_mobile_status_execute": (_int, [vp, _int, out_t]),
    "yams_mobile_doctor_execute": (_int, [vp, out_t]),
    "yams_mobile_doctor_result_json_destroy": (None, [vp]),
    "yams_mobile_search_result_stats_json": (StringView, [vp]),
    "yams_mobile_grep_result_stats_json": (StringView, [vp]),
    # section 3: field-level getters
    "yams_mobile_result_ok": (_int, [vp]),
    "yams_mobile_result_int": (_ll, [vp, cp, _ll]),
    "yams_mobile_result_double": (_dbl, [vp, cp, _dbl]),
    "yams_mobile_result_bool": (_int, [vp, cp, _int]),
    "yams_mobile_result_string": (StringView, [vp, cp]),
    "yams_mobile_result_array_len": (sz, [vp, cp]),
    "yams_mobile_result_keys": (sz, [vp, cp, _P(StringView), sz]),
    "yams_mobile_search_result_count": (sz, [vp]),
    "yams_mobile_search_result_path": (StringView, [vp, sz]),
    "yams_mobile_search_result_title": (StringView, [vp, sz]),
    "yams_mobile_search_result_snippet": (StringView, [vp, sz]),
    "yams_mobile_search_result_score": (_dbl, [vp, sz]),
    "yams_mobile_search_result_document_id": (_ll, [vp, sz]),
    "yams_mobile_search_result_total": (_ll, [vp]),
    "yams_mobile_search_result_duration_ms": (_dbl, [vp]),
    "yams_mobile_grep_result_count": (sz, [vp]),
    "yams_mobile_grep_result_path": (StringView, [vp, sz]),
    "yams_mobile_grep_result_line": (StringView, [vp, sz]),
    "yams_mobile_grep_result_line_number": (_ll, [vp, sz]),
    "yams_mobile_grep_result_files_searched": (_ll, [vp]),
    "yams_mobile_grep_result_files_matched": (_ll, [vp]),
    "yams_mobile_list_result_count": (sz, [vp]),
    "yams_mobile_list_result_path": (StringView, [vp, sz]),
    "yams_mobile_list_result_hash": (StringView, [vp, sz]),
    "yams_mobile_list_result_mime_type": (StringView, [vp, sz]),
    "yams_mobile_list_result_size": (_ll, [vp, sz]),
    "yams_mobile_document_get_result_path": (StringView, [vp]),
    "yams_mobile_document_get_result_hash": (StringView, [vp]),
    "yams_mobile_document_get_result_mime_type": (StringView, [vp]),
    "yams_mobile_document_get_result_size": (_ll, [vp]),
    "yams_mobile_document_get_result_content": (StringView, [vp]),
    "yams_mobile_status_result_document_count": (_ll, [vp]),
    "yams_mobile_status_result_block_count": (_ll, [vp]),
    "yams_mobile_status_result_state": (StringView, [vp]),
}
for _fam in ("search", "grep", "list", "document_get", "delete", "metadata",
             "graph_query", "update", "vector_status", "status"):
    SIGNATURES[f"yams_mobile_{_fam}_result_json"] = (StringView, [vp])
    SIGNATURES[f"yams_mobile_{_fam}_result_destroy"] = (None, [vp])

#!/bin/sh
# Sanitizer builds of the port's native libraries (port of
# yams_tpu/native/build_sanitized.sh, which builds the reference's one
# library; the port has three). Usage:
#   ./build_sanitized.sh asan|tsan|ubsan [out_dir] [libraries]
# builds libyams_torch_sketch.<san>.so and libyams_torch_mobile.<san>.so,
# and libyams_torch_ingest.<san>.so where <zstd.h> exists, into out_dir
# (default: yams_tpu_torch/_build); `libraries` picks some of them
# (default "sketch mobile ingest"). Then point the loader at them:
#   YAMS_TPU_TORCH_SKETCH_LIB=<out_dir>/libyams_torch_sketch.<san>.so \
#   YAMS_TPU_TORCH_MOBILE_LIB=<out_dir>/libyams_torch_mobile.<san>.so \
#   YAMS_TPU_TORCH_INGEST_LIB=<out_dir>/libyams_torch_ingest.<san>.so pytest tests/
# (asan and tsan runtimes must be loaded first: LD_PRELOAD=$(g++ -print-file-name=libasan.so)).
set -eu
HERE="$(cd "$(dirname "$0")" && pwd)"
SAN="${1:?usage: build_sanitized.sh asan|tsan|ubsan [out_dir] [libraries]}"
case "$SAN" in
  asan)  FLAGS="-fsanitize=address -fno-omit-frame-pointer" ;;
  tsan)  FLAGS="-fsanitize=thread -fno-omit-frame-pointer" ;;
  ubsan) FLAGS="-fsanitize=undefined -fno-omit-frame-pointer" ;;
  *) echo "unknown sanitizer: $SAN" >&2; exit 2 ;;
esac
OUT="${2:-$HERE/../_build}"
LIBS="${3:-sketch mobile ingest}"
wants() { case " $LIBS " in *" $1 "*) return 0 ;; *) return 1 ;; esac; }
mkdir -p "$OUT"
CXX="g++ -O1 -g -std=c++17 -shared -fPIC $FLAGS"
# the libraries build in parallel; any that fails fails the script
PIDS=""
build() {   # build <name> <sources and link flags...>
  name=$1
  shift
  $CXX "$@" -o "$OUT/libyams_torch_$name.$SAN.so" &
  PIDS="$PIDS $!:$name"
}
if wants sketch; then build sketch "$HERE/src/yams_native.cpp"; fi
if wants mobile; then build mobile "$HERE/src/yams_native.cpp" "$HERE/src/yams_mobile.cpp"; fi
if wants ingest; then
  if echo '#include <zstd.h>' | g++ -E -x c++ - >/dev/null 2>&1; then
    build ingest "$HERE/src/yams_native.cpp" "$HERE/src/ingest_pipeline.cpp" -lzstd -lpthread
  else
    echo "no <zstd.h>: the ingest library is not built"
  fi
fi
for job in $PIDS; do
  wait "${job%%:*}"
  echo "built $OUT/libyams_torch_${job#*:}.$SAN.so"
done

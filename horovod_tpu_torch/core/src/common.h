// Core types for the native coordination engine.
//
// TPU-native analog of the reference's framework-agnostic core types
// (reference horovod/common/common.h:16-115): Status, DataType, TensorShape.
// The execution side differs by design: tensors live on the Python/JAX side
// and the engine only ever sees metadata — negotiation, fusion planning, and
// completion routing are native; the collective itself is an XLA program.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace hvd {

enum class StatusType : int32_t {
  OK = 0,
  UNKNOWN = 1,
  PRECONDITION_ERROR = 2,
  ABORTED = 3,
  INVALID_ARGUMENT = 4,
  IN_PROGRESS = 5,
};

struct Status {
  StatusType type = StatusType::OK;
  std::string reason;

  static Status OK() { return Status{}; }
  static Status Unknown(std::string msg) {
    return Status{StatusType::UNKNOWN, std::move(msg)};
  }
  static Status PreconditionError(std::string msg) {
    return Status{StatusType::PRECONDITION_ERROR, std::move(msg)};
  }
  static Status Aborted(std::string msg) {
    return Status{StatusType::ABORTED, std::move(msg)};
  }
  static Status InvalidArgument(std::string msg) {
    return Status{StatusType::INVALID_ARGUMENT, std::move(msg)};
  }
  bool ok() const { return type == StatusType::OK; }
};

// Matches the Python-side dtype registry (core/engine.py DTYPES).
enum class DataType : int32_t {
  UINT8 = 0,
  INT8 = 1,
  INT32 = 2,
  INT64 = 3,
  FLOAT16 = 4,
  FLOAT32 = 5,
  FLOAT64 = 6,
  BOOL = 7,
  BFLOAT16 = 8,
};

inline int DataTypeSize(DataType dt) {
  switch (dt) {
    case DataType::UINT8:
    case DataType::INT8:
    case DataType::BOOL:
      return 1;
    case DataType::FLOAT16:
    case DataType::BFLOAT16:
      return 2;
    case DataType::INT32:
    case DataType::FLOAT32:
      return 4;
    default:
      return 8;
  }
}

inline const char* DataTypeName(DataType dt) {
  switch (dt) {
    case DataType::UINT8: return "uint8";
    case DataType::INT8: return "int8";
    case DataType::INT32: return "int32";
    case DataType::INT64: return "int64";
    case DataType::FLOAT16: return "float16";
    case DataType::FLOAT32: return "float32";
    case DataType::FLOAT64: return "float64";
    case DataType::BOOL: return "bool";
    case DataType::BFLOAT16: return "bfloat16";
  }
  return "?";
}

struct TensorShape {
  std::vector<int64_t> dims;

  int64_t num_elements() const {
    int64_t n = 1;
    for (auto d : dims) n *= d;
    return n;
  }
  bool operator==(const TensorShape& o) const { return dims == o.dims; }
  bool operator!=(const TensorShape& o) const { return !(*this == o); }
  std::string DebugString() const {
    std::string s = "[";
    for (size_t i = 0; i < dims.size(); ++i) {
      if (i) s += ", ";
      s += std::to_string(dims[i]);
    }
    return s + "]";
  }
};

}  // namespace hvd

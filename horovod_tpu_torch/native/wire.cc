// Wire format — packed binary serialization of controller messages.
//
// Host-side equivalent of the reference's FlatBuffers-based wire layer
// (horovod/common/message.cc + wire/message.fbs): Request{rank, op_type,
// reduce_op, root_rank, dtype, name, shape[]} and Response{ok, error,
// name} encoded into a compact length-prefixed little-endian buffer, so
// multi-process controller rounds ship bytes (not JSON) through the
// coordination-service KV store. ~10x smaller + no Python json overhead
// on the negotiation path.
//
// Layout (all little-endian):
//   Request:  u8 tag=1 | i32 rank | u8 op_type | u8 reduce_op
//             | i32 root_rank | u8 dtype | u16 name_len | name bytes
//             | u8 ndim | i64 shape[ndim]
//   Response: u8 tag=2 | u8 ok | u16 name_len | name | u16 err_len | err
//
// C ABI: encode into caller buffer, return bytes written (or -1 if the
// buffer is too small / malformed). Decode fills out-params.

#include <cstdint>
#include <cstring>

namespace {

inline void put_i32(uint8_t*& p, int32_t v) { memcpy(p, &v, 4); p += 4; }
inline void put_i64(uint8_t*& p, int64_t v) { memcpy(p, &v, 8); p += 8; }
inline void put_u16(uint8_t*& p, uint16_t v) { memcpy(p, &v, 2); p += 2; }
inline int32_t get_i32(const uint8_t*& p) {
  int32_t v; memcpy(&v, p, 4); p += 4; return v;
}
inline int64_t get_i64(const uint8_t*& p) {
  int64_t v; memcpy(&v, p, 8); p += 8; return v;
}
inline uint16_t get_u16(const uint8_t*& p) {
  uint16_t v; memcpy(&v, p, 2); p += 2; return v;
}

}  // namespace

extern "C" {

// Returns bytes written, or -1 on overflow.
int64_t hvt_encode_request(int32_t rank, uint8_t op_type, uint8_t reduce_op,
                           int32_t root_rank, uint8_t dtype,
                           const char* name, const int64_t* shape,
                           uint8_t ndim, uint8_t* out, int64_t out_cap) {
  uint16_t name_len = (uint16_t)strnlen(name, 65535);
  int64_t need = 1 + 4 + 1 + 1 + 4 + 1 + 2 + name_len + 1 + 8LL * ndim;
  if (need > out_cap) return -1;
  uint8_t* p = out;
  *p++ = 1;
  put_i32(p, rank);
  *p++ = op_type;
  *p++ = reduce_op;
  put_i32(p, root_rank);
  *p++ = dtype;
  put_u16(p, name_len);
  memcpy(p, name, name_len); p += name_len;
  *p++ = ndim;
  for (uint8_t i = 0; i < ndim; ++i) put_i64(p, shape[i]);
  return p - out;
}

// Decodes into out-params; name copied into name_out (cap name_cap).
// Returns 0 ok, -1 malformed.
int64_t hvt_decode_request(const uint8_t* buf, int64_t len, int32_t* rank,
                           uint8_t* op_type, uint8_t* reduce_op,
                           int32_t* root_rank, uint8_t* dtype,
                           char* name_out, int64_t name_cap,
                           int64_t* shape_out, uint8_t* ndim_out,
                           uint8_t shape_cap) {
  if (len < 14 || buf[0] != 1) return -1;
  const uint8_t* p = buf + 1;
  *rank = get_i32(p);
  *op_type = *p++;
  *reduce_op = *p++;
  *root_rank = get_i32(p);
  *dtype = *p++;
  uint16_t name_len = get_u16(p);
  if ((p - buf) + name_len + 1 > len || name_len + 1 > name_cap) return -1;
  memcpy(name_out, p, name_len);
  name_out[name_len] = 0;
  p += name_len;
  uint8_t ndim = *p++;
  if (ndim > shape_cap || (p - buf) + 8LL * ndim > len) return -1;
  for (uint8_t i = 0; i < ndim; ++i) shape_out[i] = get_i64(p);
  *ndim_out = ndim;
  return 0;
}

int64_t hvt_encode_response(uint8_t ok, const char* name, const char* error,
                            uint8_t* out, int64_t out_cap) {
  uint16_t name_len = (uint16_t)strnlen(name, 65535);
  uint16_t err_len = (uint16_t)strnlen(error, 65535);
  int64_t need = 1 + 1 + 2 + name_len + 2 + err_len;
  if (need > out_cap) return -1;
  uint8_t* p = out;
  *p++ = 2;
  *p++ = ok;
  put_u16(p, name_len);
  memcpy(p, name, name_len); p += name_len;
  put_u16(p, err_len);
  memcpy(p, error, err_len); p += err_len;
  return p - out;
}

int64_t hvt_decode_response(const uint8_t* buf, int64_t len, uint8_t* ok,
                            char* name_out, int64_t name_cap,
                            char* err_out, int64_t err_cap) {
  if (len < 6 || buf[0] != 2) return -1;
  const uint8_t* p = buf + 1;
  *ok = *p++;
  uint16_t name_len = get_u16(p);
  if ((p - buf) + name_len + 2 > len || name_len + 1 > name_cap) return -1;
  memcpy(name_out, p, name_len);
  name_out[name_len] = 0;
  p += name_len;
  uint16_t err_len = get_u16(p);
  if ((p - buf) + err_len > len || err_len + 1 > err_cap) return -1;
  memcpy(err_out, p, err_len);
  err_out[err_len] = 0;
  return 0;
}

}  // extern "C"

// CAN frame hex text encoding/decoding and Kia Cee'd frame parsers.
//
// Text format (recorder logs): "<hex id> <hex byte> <hex byte> ...",
// exactly two hex chars per byte, single-space separated, optional trailing
// separator (reference: src/car/can.cc:55-124). Kia decoding: steering angle
// frame 0x2B0 (int16 deci-degrees, 5-byte payload, 32767 = invalid) and
// wheel-speed frame 0x4B0 (4 x int16, 8-byte payload)
// (reference: include/car/kia_can.hpp:19-26, src/car/kia_can.cc:11-73).
#ifndef PGCAR_CAN_FRAME_H_
#define PGCAR_CAN_FRAME_H_

#include <cstdint>
#include <string>

namespace pgcar {

constexpr size_t kCanMaxPayload = 8;

struct CanFrame {
  uint32_t id = 0;
  uint8_t length = 0;
  uint8_t data[kCanMaxPayload] = {};
};

bool TryParseCanFrame(const std::string &text, CanFrame *frame);
std::string CanFramePayloadToHex(const CanFrame &frame);

namespace kia {

constexpr uint32_t kSteeringWheelAngleCanId = 0x2B0;
constexpr uint8_t kSteeringWheelAnglePayloadSize = 5;
constexpr int16_t kSteeringWheelAngleInvalidValue = 32767;
constexpr uint32_t kVelocityCanId = 0x4B0;
constexpr uint8_t kVelocityPayloadSize = 8;

int16_t ParseCanInt16(const uint8_t *bytes);

// Overflow-safe truncated integer mean. NOTE: the reference's version
// (kia_can.cc:27-36) accumulates v - v/n where v % n is evidently intended,
// inflating the result ~1.75x for n=4; this is the corrected computation
// (see pilotguru/formats/can.py for the parity discussion).
int16_t IntegerAverage(const int16_t *values, size_t count);

struct SteeringAngle {
  int16_t angle_deci_degrees = 0;
  double degrees() const { return angle_deci_degrees / 10.0; }
};

struct WheelSpeeds {
  int16_t front_left = 0, front_right = 0, rear_left = 0, rear_right = 0;
  int16_t average() const {
    const int16_t v[4] = {front_left, front_right, rear_left, rear_right};
    return IntegerAverage(v, 4);
  }
};

// Return true + fill output on a well-formed payload, false otherwise.
bool ParseSteeringAngle(const CanFrame &frame, SteeringAngle *out);
bool ParseWheelSpeeds(const CanFrame &frame, WheelSpeeds *out);

}  // namespace kia
}  // namespace pgcar

#endif  // PGCAR_CAN_FRAME_H_

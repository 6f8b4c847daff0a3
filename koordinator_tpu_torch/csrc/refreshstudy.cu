// The warm refresh's study build: schedule.cu without the refresh's 2-KB
// parameter block, so that every plan up to 7,168 words rides in the 28-KB
// one, for `chip_smoke.py --refresh` to time the two blocks on the same
// plans.  No path of the port loads it: cuda.build compiles it only when a
// study binds one of its entry points (cuda.STUDY).
#define KOORD_REFRESH_STUDY
#include "schedule.cu"

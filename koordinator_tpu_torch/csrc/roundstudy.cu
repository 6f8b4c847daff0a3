// The round loop's study build: schedule.cu compiled with its phase split
// (SM cycles by phase of three blocks, read by koord_round_split) and with
// a round's synchronisation alone as a kernel of its own
// (koord_round_sync), for `chip_smoke.py --rounds`.  No path of the port
// loads it: cuda.build compiles it only when a study binds one of its
// entry points (cuda.STUDY), and the library the paths launch carries
// none of this.
#define KOORD_ROUND_STUDY
#include "schedule.cu"

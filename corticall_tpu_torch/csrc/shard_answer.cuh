// The answer row a shard returns for a query (ctk_shard_answer writes it,
// ctk_shard_walk_step and ctk_link_step read it), and MAX_ADD, the link rows
// a k-mer adds to a LinkStore (csrc/link_store.cuh).  The Python side of the
// layout is ops/sharding.py's ANS_* columns.
//
// int32 columns: the shard-local record (-1: a miss), the combined edge
// byte, and for the linked walk the record's link count, then its first
// MAX_ADD link rows as choice words (two a row), lengths and forward flags.
#pragma once

namespace {

constexpr int kMaxAdd = 16;  // walk_links.MAX_ADD; the store's CAP is the warp
constexpr int kAnsRec = 0, kAnsEdge = 1, kAnsCnt = 2, kAnsChoices = 3,
              kAnsLen = kAnsChoices + 2 * kMaxAdd, kAnsFw = kAnsLen + kMaxAdd,
              kWalkAnswer = 2, kLinkAnswer = kAnsFw + kMaxAdd;

}  // namespace

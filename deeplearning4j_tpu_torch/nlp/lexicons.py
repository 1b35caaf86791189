"""Bundled CJK lexicons for lattice segmentation (``cjk.py``).

The reference vendors full morphological dictionaries (ansj for Chinese,
kuromoji for Japanese — ~20k LoC of data each,
``deeplearning4j-nlp-chinese/``, ``-japanese/``).  This bundle is a curated
high-frequency core of a few thousand entries per language — enough for the
Viterbi lattice to segment ordinary open-domain sentences; domain users
merge in their own dictionary through the factory argument (user entries
outrank bundled ones).  Segmentation quality is MEASURED, not asserted:
``tests/resources/cjk_gold_*.txt`` hold tagged gold segmentations and
``test_text_utils`` enforces a word-level F1 floor against them.

Scores are log-probabilities by frequency band; multi-character dictionary
words must beat sequences of single-character/OOV fallbacks.
"""
from __future__ import annotations

from typing import Dict

# frequency bands (log-prob per word)
_TOP = -4.0      # function words / ubiquitous
_HIGH = -5.5     # everyday vocabulary
_MID = -7.0      # common nouns/verbs
_LOW = -8.0      # less common but standard vocabulary
_OOV_CHAR = -9.5  # per-character fallback used by the lattice


def _add(lex: Dict[str, float], words: str, score: float) -> None:
    """Accumulate a frequency band.  A word listed in several bands keeps
    its HIGHEST score (max-merge) — plain dict.update would let a later
    thematic band silently downgrade a top-frequency function word."""
    for w in words.split():
        prev = lex.get(w)
        lex[w] = score if prev is None else max(prev, score)


CHINESE_LEXICON: Dict[str, float] = {}

# -- single-character function words / ubiquitous morphemes ------------------
_add(CHINESE_LEXICON, 
    "的 了 在 是 我 你 他 她 它 不 和 有 这 那 就 也 都 很 到 说 要 去 会 着 "
    "没 看 好 自 己 上 下 大 小 多 少 人 年 月 日 中 国 来 对 能 还 想 过 让 "
    "被 把 给 从 向 跟 为 以 用 而 或 但 与 并 等 再 最 更 才 只 又 先 别 些 "
    "种 个 位 件 条 张 本 台 辆 场 次 回 点 前 后 里 外 左 右 东 西 南 北", _TOP)

# -- pronouns / demonstratives / question words ------------------------------
_add(CHINESE_LEXICON, 
    "我们 你们 他们 她们 它们 咱们 大家 自己 别人 人家 彼此 "
    "什么 怎么 怎样 为什么 哪里 哪儿 哪个 多少 几个 何时 谁的 "
    "这个 那个 这些 那些 这里 那里 这儿 那儿 这样 那样 此外 其中 其他 其它 "
    "某个 某些 任何 所有 一切 每个 各个 各种 各自", _HIGH)

# -- time ---------------------------------------------------------------------
_add(CHINESE_LEXICON, 
    "现在 时候 时间 今天 明天 昨天 前天 后天 今年 明年 去年 以前 以后 之前 "
    "之后 最近 将来 未来 过去 当时 刚才 马上 立刻 早上 上午 中午 下午 晚上 "
    "夜里 半夜 凌晨 周末 星期 礼拜 小时 分钟 秒钟 世纪 年代 季节 春天 夏天 "
    "秋天 冬天 春节 假期 生日 纪念日 始终 永远 暂时 同时 平时 有时 随时 "
    "当初 如今 目前 近来 早晚 从前 晚间 期间 阶段 时期 时代 岁月", _HIGH)

# -- common verbs -------------------------------------------------------------
_add(CHINESE_LEXICON, 
    "可以 没有 知道 觉得 认为 喜欢 希望 需要 应该 愿意 打算 决定 选择 考虑 "
    "开始 结束 继续 停止 进行 完成 实现 成为 变成 发生 出现 消失 存在 保持 "
    "工作 生活 学习 使用 利用 采用 应用 运用 帮助 支持 反对 同意 答应 拒绝 "
    "接受 收到 得到 获得 取得 失去 丢失 找到 发现 寻找 研究 分析 讨论 交流 "
    "介绍 说明 解释 表示 表达 表现 显示 证明 提出 提供 提高 增加 减少 降低 "
    "扩大 缩小 改变 改进 改善 调整 控制 管理 组织 安排 计划 准备 参加 参与 "
    "举行 举办 召开 建立 建设 创造 创新 发明 生产 制造 制作 设计 开发 发展 "
    "进入 离开 回来 回去 出去 出来 进来 到达 经过 通过 穿过 越过 走路 跑步 "
    "起来 起床 睡觉 休息 吃饭 喝水 做饭 洗澡 穿衣 打扮 上班 下班 上学 放学 "
    "开车 坐车 骑车 乘坐 旅行 旅游 参观 访问 拜访 见面 约会 聊天 谈话 商量 "
    "购买 出售 销售 付钱 花钱 赚钱 挣钱 储蓄 投资 借钱 还钱 租房 买房 搬家 "
    "打开 关闭 关上 放下 拿起 拿走 带来 带走 送给 交给 递给 寄给 传给 留给 "
    "记得 记住 忘记 想起 想念 思考 思念 怀念 相信 怀疑 担心 害怕 恐惧 紧张 "
    "放心 小心 注意 重视 忽视 忽略 关心 关注 照顾 保护 爱护 尊重 尊敬 佩服 "
    "感谢 感激 道歉 原谅 批评 表扬 称赞 夸奖 鼓励 安慰 祝贺 祝福 欢迎 招待 "
    "等待 等候 期待 盼望 渴望 要求 请求 恳求 命令 允许 禁止 阻止 避免 防止 "
    "影响 导致 造成 引起 产生 促进 推动 推进 加强 增强 减轻 缓解 解决 "
    "处理 对待 面对 面临 遇到 碰到 经历 体验 感受 感觉 感到 察觉 意识 理解 "
    "明白 懂得 掌握 熟悉 了解 认识 学会 教授 培养 训练 练习 复习 预习 考试 "
    "毕业 入学 报名 申请 注册 登记 填写 签字 盖章 提交 上交 发送 接收 下载 "
    "上传 安装 卸载 打印 复制 粘贴 删除 保存 修改 编辑 检查 测试 运行 启动", _MID)

# -- connectives / adverbs / adjectives --------------------------------------
_add(CHINESE_LEXICON, 
    "因为 所以 但是 可是 不过 然而 而且 并且 或者 还是 虽然 尽管 如果 假如 "
    "只要 只有 无论 不管 既然 于是 因此 总之 另外 然后 接着 最后 终于 "
    "已经 正在 曾经 从来 一直 总是 经常 常常 往往 偶尔 有时候 忽然 突然 "
    "非常 十分 特别 格外 相当 比较 更加 越来越 稍微 略微 几乎 差点 大约 "
    "一起 一个 一些 一样 一般 一定 一共 一边 一面 首先 其次 再次 "
    "当然 确实 的确 其实 实际上 事实上 显然 明显 或许 也许 可能 大概 恐怕 "
    "幸好 幸亏 果然 居然 竟然 反而 反正 毕竟 究竟 到底 简直 尤其 主要 "
    "高兴 快乐 愉快 开心 兴奋 激动 感动 满意 得意 幸福 舒服 舒适 轻松 "
    "难过 伤心 痛苦 悲伤 失望 绝望 生气 愤怒 烦恼 着急 焦虑 孤独 寂寞 "
    "漂亮 美丽 好看 可爱 英俊 帅气 丑陋 干净 整洁 肮脏 清楚 模糊 明亮 黑暗 "
    "安静 热闹 吵闹 嘈杂 拥挤 宽敞 狭窄 巨大 庞大 微小 细小 高大 矮小 "
    "重要 次要 必要 必须 关键 核心 基本 根本 主动 被动 积极 消极 "
    "容易 简单 困难 复杂 方便 麻烦 危险 安全 健康 疾病 强壮 虚弱 疲劳 "
    "新鲜 陈旧 古老 现代 先进 落后 流行 时髦 传统 经典 正式 随便 认真 马虎 "
    "聪明 愚蠢 笨拙 机智 勤奋 努力 懒惰 勇敢 胆小 诚实 虚伪 善良 邪恶 温柔 "
    "严格 严肃 温和 热情 冷淡 友好 礼貌 客气 谦虚 骄傲 自信 害羞 大方 小气 "
    "便宜 昂贵 免费 贵重 富有 贫穷 豪华 简朴 节约 浪费 充足 缺乏 丰富 单调 "
    "快速 迅速 缓慢 匆忙 及时 准时 迟到 提前 推迟 长久 短暂 临时 正好 合适", _MID)

# -- people / family / professions -------------------------------------------
_add(CHINESE_LEXICON, 
    "朋友 先生 女士 小姐 孩子 父母 父亲 母亲 爸爸 妈妈 爷爷 奶奶 外公 外婆 "
    "哥哥 弟弟 姐姐 妹妹 丈夫 妻子 儿子 女儿 孙子 孙女 亲戚 邻居 同学 同事 "
    "老板 员工 职员 干部 领导 经理 主任 秘书 助理 顾问 专家 学者 教授 博士 "
    "硕士 学士 医生 护士 病人 患者 律师 法官 警察 军人 士兵 司机 乘客 厨师 "
    "服务员 售货员 收银员 理发师 工程师 程序员 设计师 建筑师 会计师 记者 "
    "编辑 作家 诗人 画家 歌手 演员 导演 明星 运动员 教练 裁判 农民 工人 "
    "商人 企业家 科学家 艺术家 音乐家 翻译 导游 模特 保安 保姆 清洁工 "
    "青年 少年 儿童 婴儿 成人 老人 男人 女人 男孩 女孩 人们 人口 人类 人民 "
    "观众 听众 读者 作者 用户 顾客 客户 客人 主人 对手 敌人 伙伴 搭档 队友 "
    "老师 学生 师生 家长 校长 院长 班长 同伴 同行", _MID)

# -- places / geography -------------------------------------------------------
_add(CHINESE_LEXICON, 
    "中国 北京 上海 广州 深圳 天津 重庆 香港 澳门 台湾 南京 杭州 苏州 武汉 "
    "成都 西安 长沙 郑州 青岛 大连 厦门 昆明 拉萨 乌鲁木齐 哈尔滨 沈阳 "
    "美国 英国 法国 德国 日本 韩国 印度 俄罗斯 意大利 西班牙 加拿大 澳大利亚 "
    "巴西 埃及 纽约 伦敦 巴黎 东京 首尔 莫斯科 亚洲 欧洲 非洲 美洲 大洋洲 "
    "世界 国家 城市 乡村 农村 郊区 市区 地区 区域 省份 县城 乡镇 村庄 社区 "
    "学校 学院 大学 中学 小学 幼儿园 教室 操场 宿舍 食堂 礼堂 实验室 图书馆 "
    "医院 诊所 药店 银行 邮局 商店 超市 市场 商场 书店 饭店 餐厅 酒店 宾馆 "
    "公司 工厂 车间 仓库 办公室 会议室 政府 法院 机关 单位 部门 机构 组织 "
    "公园 广场 花园 动物园 植物园 博物馆 美术馆 体育馆 电影院 剧院 游乐场 "
    "车站 火车站 汽车站 地铁站 机场 码头 港口 停车场 加油站 路口 街道 马路 "
    "公路 铁路 高速 桥梁 隧道 大厦 大楼 建筑 房子 房间 卧室 客厅 厨房 厕所 "
    "卫生间 阳台 楼梯 电梯 门口 窗户 屋顶 地下室 院子 大门 走廊 大厅 "
    "山脉 高山 河流 江河 湖泊 海洋 大海 海边 沙滩 岛屿 森林 树林 草原 沙漠 "
    "平原 高原 盆地 山谷 瀑布 温泉 天空 大地 地球 月球 太空 宇宙 星球", _MID)

# -- objects / food / nature --------------------------------------------------
_add(CHINESE_LEXICON, 
    "东西 事情 事物 物品 物体 问题 答案 方法 办法 方式 方面 情况 状态 状况 "
    "条件 环境 背景 基础 结构 系统 过程 结果 原因 理由 目的 目标 任务 责任 "
    "飞机 火车 汽车 电车 地铁 公交 巴士 出租车 自行车 摩托车 卡车 轮船 "
    "电脑 手机 电话 电视 冰箱 洗衣机 空调 风扇 微波炉 电灯 灯泡 插座 电池 "
    "相机 照相机 摄像机 收音机 录音机 音响 耳机 键盘 鼠标 屏幕 显示器 打印机 "
    "桌子 椅子 沙发 床铺 柜子 书架 书桌 抽屉 镜子 地毯 窗帘 枕头 被子 床单 "
    "衣服 裤子 裙子 衬衫 外套 大衣 毛衣 内衣 袜子 鞋子 帽子 手套 围巾 腰带 "
    "眼镜 手表 戒指 项链 耳环 背包 书包 钱包 行李 箱子 雨伞 钥匙 锁头 "
    "米饭 面条 面包 馒头 包子 饺子 鸡蛋 牛奶 豆浆 咖啡 红茶 绿茶 果汁 "
    "啤酒 葡萄酒 白酒 饮料 矿泉水 蔬菜 水果 苹果 香蕉 橘子 葡萄 西瓜 草莓 "
    "桃子 梨子 樱桃 柠檬 菠萝 芒果 土豆 番茄 西红柿 黄瓜 白菜 萝卜 洋葱 "
    "猪肉 牛肉 羊肉 鸡肉 鸭肉 鱼肉 海鲜 虾仁 豆腐 糖果 巧克力 饼干 蛋糕 "
    "零食 点心 调料 酱油 食盐 白糖 味精 辣椒 大蒜 生姜 食物 食品 饭菜 菜单 "
    "动物 植物 花草 树木 叶子 树叶 花朵 玫瑰 种子 果实 小草 竹子 松树 "
    "猫咪 小狗 小鸟 鸟儿 鱼儿 兔子 老虎 狮子 大象 猴子 熊猫 长颈鹿 斑马 "
    "牛羊 马匹 鸡鸭 昆虫 蝴蝶 蜜蜂 蚂蚁 蚊子 苍蝇 蜘蛛 青蛙 "
    "天气 气候 温度 气温 阳光 太阳 月亮 星星 云彩 白云 乌云 风雨 大风 微风 "
    "下雨 小雨 大雨 暴雨 雷雨 闪电 打雷 下雪 大雪 雪花 冰雹 彩虹 雾气 霜冻 "
    "空气 氧气 水分 火焰 火灾 烟雾 灰尘 泥土 土壤 石头 岩石 沙子 金属 黄金 "
    "白银 铁器 玻璃 塑料 木头 木材 纸张 布料 皮革 棉花 丝绸 橡胶 水泥 砖头", _MID)

# -- abstract / society / economy / tech -------------------------------------
_add(CHINESE_LEXICON, 
    "经济 发展 技术 科学 研究 教育 文化 历史 社会 政府 政治 法律 法规 政策 "
    "语言 文字 汉语 中文 英语 外语 文学 小说 诗歌 散文 文章 报告 论文 作文 "
    "数据 信息 消息 新闻 媒体 报纸 杂志 广播 节目 频道 广告 宣传 出版 发表 "
    "计算 模型 机器 设备 仪器 工具 机械 引擎 发动机 零件 部件 材料 原料 "
    "网络 互联网 网站 网页 网址 邮箱 邮件 短信 微信 视频 音频 图片 照片 "
    "软件 硬件 程序 代码 算法 函数 变量 参数 数字 数量 数学 物理 化学 生物 "
    "地理 天文 医学 药物 药品 疫苗 手术 治疗 诊断 症状 感冒 发烧 咳嗽 "
    "电影 音乐 歌曲 舞蹈 戏剧 京剧 相声 小品 绘画 书法 雕塑 摄影 艺术 美术 "
    "体育 运动 比赛 竞赛 冠军 亚军 足球 篮球 排球 乒乓球 羽毛球 网球 游泳 "
    "爬山 登山 滑雪 滑冰 武术 太极 瑜伽 健身 锻炼 奥运会 世界杯 "
    "金钱 货币 人民币 美元 价格 价值 成本 费用 工资 收入 支出 利润 税收 "
    "贸易 商业 产业 行业 企业 商品 产品 质量 品牌 服务 消费 "
    "股票 基金 保险 贷款 利息 理财 账户 存款 现金 支付 转账 "
    "国际 国内 全球 全国 地方 中央 民族 民主 自由 平等 和平 战争 军队 武器 "
    "秩序 制度 体制 改革 开放 革命 现代化 全球化 城市化 信息化 "
    "思想 观念 观点 意见 建议 态度 精神 心理 心情 情绪 情感 感情 爱情 友情 "
    "亲情 婚姻 家庭 道德 品质 性格 习惯 兴趣 爱好 梦想 理想 信念 信心 勇气 "
    "生命 命运 灵魂 智慧 记忆 意志 意义 价值观 世界观 人生 人生观 "
    "能力 实力 水平 标准 规则 规定 原则 方案 项目 工程 成果 "
    "更多 更好 大量 少量 资源 能源 资本 资金 资料 素材 "
    "第一 第二 第三 生产力 起飞 降落 出发 抵达 "
    "成绩 成功 失败 进步 退步 优点 缺点 优势 劣势 机会 机遇 挑战 风险 危机 "
    "人工智能 机器学习 深度学习 神经网络 自然语言 大数据 云计算 物联网 "
    "区块链 虚拟现实 芯片 半导体 机器人 无人机 新能源 电动车 高科技", _MID)

# -- longer compounds ---------------------------------------------------------
_add(CHINESE_LEXICON, 
    "计算机 办公室 出租车 图书馆 互联网 研究生 科学家 实验室 火车站 飞机场 "
    "电影院 博物馆 幼儿园 体育馆 游泳池 停车场 加油站 派出所 大使馆 动物园 "
    "植物园 美术馆 洗手间 卫生间 售货员 服务员 工程师 程序员 设计师 建筑师 "
    "运动员 艺术家 音乐家 企业家 外国人 年轻人 中国人 当事人 负责人 收音机 "
    "洗衣机 电冰箱 照相机 摄像机 计算器 显示器 打印机 微波炉 电视机 笔记本 "
    "身份证 信用卡 银行卡 联合国 "
    "大学生 中学生 小学生 留学生 毕业生 研究员 志愿者 消费者 生产者 爱好者", _MID)

JAPANESE_LEXICON: Dict[str, float] = {}
# particles and auxiliaries — the backbone of the lattice
# (aligned with IPADIC/kuromoji morpheme granularity — the
# reference's JapaneseTokenizer splits で|は, し|て, まし|た, だろ|う; the
# fused surface forms the earlier bands carried fought the corpus tier
# learned from the IPADIC-tokenized corpus and are removed)
_add(JAPANESE_LEXICON,
    "は が を に で と も の へ や から まで より ね よ か な ので のに けど "
    "だけ しか ばかり ほど くらい ぐらい など って でも じゃ", _TOP)
_add(JAPANESE_LEXICON,
    "です ます ない いる ある する き て た まし でし ませ だろ でしょ "
    "し い う ん お ご だ である ください できる られる れる せる "
    "たい よう ながら たり ば なら", _TOP)

# -- pronouns / demonstratives / question words ------------------------------
_add(JAPANESE_LEXICON, 
    "私 あなた 彼 彼女 これ それ あれ ここ そこ どこ 誰 何 今 人 年 月 日 "
    "時 分 中 上 下 大 小 僕 俺 君 皆 どれ どの この その あの "
    "こちら そちら あちら どちら こんな そんな あんな どんな いつ いくら "
    "なぜ どうして どう こう そう 自分 私たち 彼ら みんな 皆さん", _HIGH)

# -- everyday expressions -----------------------------------------------------
_add(JAPANESE_LEXICON, 
    "わたし きょう あした きのう こんにちは ありがとう さようなら おはよう "
    "こんばんは すみません ごめんなさい はじめまして どうぞ "
    "どうも おやすみ いただき ください もの こと とき "
    "ところ ため わけ はず つもり まま とおり うち あいだ あと まえ", _HIGH)

# -- time ---------------------------------------------------------------------
_add(JAPANESE_LEXICON, 
    "時間 今日 明日 昨日 今年 去年 来年 今月 先月 来月 今週 先週 来週 毎日 "
    "毎週 毎月 毎年 毎朝 毎晩 朝 昼 夜 夕方 夜中 午前 午後 最近 将来 未来 "
    "過去 現在 昔 当時 最初 最後 途中 週末 平日 休日 祝日 正月 季節 春 夏 "
    "秋 冬 時代 時期 期間 瞬間 曜日 月曜日 火曜日 水曜日 木曜日 金曜日 "
    "土曜日 日曜日 誕生日 記念日 予定 約束", _MID)

# -- places -------------------------------------------------------------------
_add(JAPANESE_LEXICON, 
    "日本 東京 大阪 京都 名古屋 横浜 神戸 福岡 札幌 仙台 広島 沖縄 奈良 "
    "中国 韓国 アメリカ イギリス フランス ドイツ イタリア スペイン ロシア "
    "インド カナダ オーストラリア ブラジル アジア ヨーロッパ アフリカ "
    "学校 学生 先生 大学 高校 中学 小学校 幼稚園 教室 校庭 図書館 研究室 "
    "会社 仕事 職場 工場 事務所 会議室 役所 銀行 郵便局 病院 薬局 警察 "
    "駅 空港 港 停留所 駐車場 交差点 道路 通り 橋 トンネル 街 町 村 都市 "
    "田舎 地方 地域 国 世界 地球 宇宙 海外 国内 故郷 "
    "店 お店 商店 スーパー コンビニ デパート 市場 本屋 書店 パン屋 花屋 "
    "レストラン 喫茶店 カフェ 居酒屋 食堂 ホテル 旅館 温泉 "
    "公園 広場 庭 動物園 植物園 博物館 美術館 映画館 劇場 体育館 プール "
    "神社 寺 お寺 教会 城 お城 タワー ビル マンション アパート 家 部屋 "
    "台所 キッチン 風呂 お風呂 トイレ 玄関 廊下 階段 屋上 地下 窓 ドア "
    "山 川 海 湖 池 島 森 林 草原 砂漠 平野 谷 滝 海岸 浜辺 空 大地", _MID)

# -- people / family ----------------------------------------------------------
_add(JAPANESE_LEXICON, 
    "家族 父 母 お父さん お母さん 両親 兄 弟 姉 妹 お兄さん お姉さん 夫 妻 "
    "息子 娘 子供 赤ちゃん 祖父 祖母 おじいさん おばあさん 孫 親戚 いとこ "
    "友達 友人 親友 恋人 彼氏 夫婦 家内 主人 "
    "男 女 男性 女性 男の子 女の子 大人 子ども 老人 若者 青年 少年 少女 "
    "医者 看護師 患者 弁護士 裁判官 警察官 消防士 軍人 運転手 店員 駅員 "
    "社長 部長 課長 係長 社員 職員 公務員 会社員 サラリーマン 主婦 "
    "教授 博士 研究者 科学者 技術者 エンジニア プログラマー デザイナー "
    "記者 作家 詩人 画家 歌手 俳優 女優 監督 選手 コーチ 審判 農家 漁師 "
    "料理人 コック パイロット 客 お客さん お客様 観客 読者 利用者 住民", _MID)

# -- common nouns -------------------------------------------------------------
_add(JAPANESE_LEXICON, 
    "電車 自動車 車 バス タクシー 自転車 バイク 飛行機 船 新幹線 地下鉄 "
    "天気 天候 気温 気候 雨 晴れ 曇り 雪 風 台風 地震 雷 虹 霧 "
    "本 水 お水 お湯 火 電気 ガス 食事 料理 朝食 昼食 夕食 朝ご飯 昼ご飯 "
    "晩ご飯 ご飯 パン 麺 そば うどん ラーメン 寿司 刺身 天ぷら カレー "
    "肉 牛肉 豚肉 鶏肉 魚 卵 野菜 果物 米 豆腐 味噌 醤油 砂糖 塩 "
    "りんご みかん バナナ ぶどう いちご 桃 梨 スイカ トマト じゃがいも "
    "お茶 紅茶 緑茶 コーヒー 牛乳 ジュース ビール ワイン お酒 飲み物 "
    "お菓子 ケーキ チョコレート アイスクリーム クッキー デザート "
    "映画 音楽 写真 電話 部屋 家具 机 椅子 テーブル ソファ ベッド 棚 本棚 "
    "冷蔵庫 洗濯機 掃除機 エアコン テレビ ラジオ カメラ パソコン スマホ "
    "携帯 携帯電話 時計 腕時計 眼鏡 傘 鍵 財布 鞄 かばん リュック 荷物 "
    "服 洋服 着物 シャツ ズボン スカート コート セーター 靴 靴下 帽子 "
    "手袋 マフラー ネクタイ ベルト 指輪 "
    "言葉 日本語 英語 中国語 韓国語 フランス語 単語 文字 漢字 ひらがな "
    "カタカナ 文章 文法 発音 会話 意味 名前 住所 番号 電話番号 手紙 葉書 "
    "切手 封筒 新聞 雑誌 辞書 教科書 ノート 鉛筆 ペン 消しゴム 紙 地図 "
    "体 頭 顔 目 耳 鼻 口 歯 首 肩 手 指 足 腕 背中 腹 お腹 心 心臓 髪 "
    "犬 猫 鳥 馬 牛 豚 羊 兎 虎 象 猿 熊 鼠 蛇 虫 蝶 蜂 "
    "花 桜 梅 菊 バラ 木 草 葉 根 種 実 松 竹", _MID)

# -- abstract / society / study ----------------------------------------------
_add(JAPANESE_LEXICON, 
    "勉強 研究 科学 技術 計算 情報 世界 問題 宿題 授業 講義 試験 テスト "
    "受験 入学 卒業 留学 教育 学問 知識 経験 練習 復習 予習 質問 答え 説明 "
    "発表 報告 論文 資料 データ 結果 原因 理由 目的 目標 方法 手段 計画 "
    "準備 予約 確認 連絡 相談 会議 打ち合わせ "
    "経済 政治 社会 文化 歴史 伝統 宗教 法律 制度 政策 選挙 政府 国家 国民 "
    "市民 組織 団体 グループ チーム 委員会 協会 "
    "職業 業務 作業 労働 給料 収入 支出 値段 価格 料金 費用 お金 "
    "現金 貯金 買い物 売買 貿易 産業 工業 農業 商業 企業 経営 市場 商品 "
    "製品 品質 サービス 販売 生産 消費 "
    "元気 気分 気持ち 心配 安心 不安 緊張 興奮 感動 感謝 喜び 悲しみ 怒り "
    "驚き 恐怖 楽しみ 苦しみ 痛み 疲れ 病気 怪我 風邪 熱 咳 頭痛 腹痛 "
    "健康 体調 治療 手術 検査 診察 入院 退院 薬 注射 "
    "性格 性質 特徴 特色 個性 才能 能力 実力 技能 資格 免許 "
    "意見 考え 思い 気 心 夢 希望 理想 興味 関心 趣味 習慣 生活 人生 "
    "運動 スポーツ 野球 サッカー テニス バスケットボール バレーボール "
    "卓球 水泳 柔道 剣道 空手 相撲 マラソン 散歩 旅行 観光 登山 釣り "
    "ゲーム 遊び 踊り 歌 絵 書道 茶道 華道 文学 小説 詩 物語 漫画 アニメ "
    "番組 ニュース ドラマ コンサート 祭り 花火 パーティー 結婚式 "
    "成功 失敗 進歩 発展 発達 変化 成長 増加 減少 上昇 下降 改善 改革 "
    "良い 悪い 高い 安い 大きい 小さい 新しい 古い 長い 短い 広い 狭い "
    "重い 軽い 強い 弱い 速い 遅い 近い 遠い 多い 少ない 早い 暑い 寒い "
    "暖かい 涼しい 熱い 冷たい 明るい 暗い 白い 黒い 赤い 青い 黄色い "
    "美しい きれい 可愛い かわいい 面白い つまらない 楽しい いい 良い "
    "嬉しい 悲しい 寂しい 怖い 難しい 易しい 簡単 複雑 便利 不便 大切 "
    "大事 重要 必要 十分 不足 有名 普通 特別 自由 平和 安全 危険 静か "
    "賑やか 親切 丁寧 真面目 正直 幸せ 残念 大丈夫 無理 駄目", _MID)

# -- verbs (dictionary + masu-stem; te/ta handled by lattice) ----------------
_add(JAPANESE_LEXICON, 
    "食べる 飲む 行く 来る 見る 聞く 話す 読む 書く 買う 作る 使う 思う "
    "知る 分かる 食べ 飲み 行き 来 見 聞き 話し 読み 書き 買い 作り 使い "
    "思い 知り 分かり 言う 言い 出る 出 入る 入り 帰る 帰り 歩く 歩き "
    "走る 走り 泳ぐ 泳ぎ 飛ぶ 飛び 乗る 乗り 降りる 降り 待つ 待ち 会う "
    "会い 休む 休み 働く 働き 遊ぶ 遊び 寝る 寝 起きる 起き 座る 座り "
    "立つ 立ち 開ける 開け 閉める 閉め 始める 始め 終わる 終わり 続ける "
    "続け 止まる 止まり 動く 動き 変わる 変わり 考える 考え 感じる 感じ "
    "覚える 覚え 忘れる 忘れ 教える 教え 習う 習い 学ぶ 学び 調べる 調べ "
    "探す 探し 見つける 見つけ 選ぶ 選び 決める 決め 持つ 持ち 取る 取り "
    "置く 置き 渡す 渡し 送る 送り 届ける 届け 受ける 受け もらう あげる "
    "くれる 貸す 借りる 返す 返し 払う 払い 売る 売り 洗う 洗い 着る 着 "
    "脱ぐ 脱ぎ 履く 切る 切り 貼る 運ぶ 運び 投げる 投げ 拾う 押す 押し "
    "引く 引き 回す 回し 曲がる 曲がり 渡る 進む 進み 戻る 戻り 急ぐ 急ぎ "
    "集める 集め 並ぶ 並び 数える 測る 比べる 比べ 直す 直し 壊す 壊れる "
    "落とす 落ちる 上がる 上げる 下がる 下げる 増える 増やす 減る 減らす "
    "生まれる 生まれ 死ぬ 住む 住み 勤める 勤め 通う 通い 移る 移し 呼ぶ "
    "呼び 頼む 頼み 手伝う 手伝い 助ける 助け 守る 守り 笑う 笑い 泣く "
    "泣き 怒る 怒り 喜ぶ 驚く 困る 困り 疲れる 頑張る 頑張り 努力 挨拶 "
    "紹介 案内 招待 訪問 出発 到着 出席 欠席 参加 見学 理解 記憶 "
    "想像 判断 決定 選択 比較 検討 分析 調査 観察 実験 発見 発明 開発 "
    "製作 建設 修理 掃除 洗濯 運転 入浴 化粧 結婚 離婚 就職 "
    "退職 引っ越し 節約 注文", _MID)

# -- conjugated stems (IPADIC granularity: the て/で particle splits off;
# the 連用形/促音便 stem is its own token — 帰っ|て, 読ん|で, 行き|ます) ----
_add(JAPANESE_LEXICON,
    "行っ 来 見 食べ 飲ん 読ん 書い 買っ 作っ 使っ 思っ 知っ 話し 聞い "
    "進ん 遊ん 教え 覚え 働い 住ん 持っ 待っ 取っ 乗っ 歩い 走っ 泳い "
    "飛ん 帰っ 入っ 出 起き 寝 座っ 立っ 開け 閉め 始め 終わっ 止まっ "
    "動い 変わっ 考え 感じ 忘れ 調べ 探し 見つけ 選ん 決め 置い 渡し "
    "送っ 受け 払っ 売っ 洗っ 着 切っ 押し 引い 並ん 笑っ 泣い 怒っ "
    "困っ 疲れ 頑張っ 会っ 呼ん 頼ん 手伝っ 助け 守っ 習っ 学ん 集め "
    "戻っ 急い 曲がっ 渡っ 運ん 投げ 拾っ 降り "
    "行き 言っ 言い やっ なっ なら なれ あっ "
    "近く 遠く 多く 早く 遅く 高く 安く 強く 弱く 良く よく 悪く "
    "美味しい おいしい 美味しく", _MID)

# -- katakana loanwords -------------------------------------------------------
_add(JAPANESE_LEXICON, 
    "コンピュータ コンピューター インターネット ニュース テレビ カメラ "
    "ホテル レストラン パソコン スマートフォン タブレット アプリ ソフト "
    "ウェブ サイト ページ メール ゲーム データ ファイル システム ネット "
    "プログラム ロボット デジタル オンライン ダウンロード アップロード "
    "ビル エレベーター エスカレーター ドア ガラス テーブル ソファ カーテン "
    "ベッド シャワー キッチン "
    "バス タクシー トラック オートバイ ヘリコプター ロケット "
    "シャツ ズボン スカート コート セーター ジャケット ドレス スーツ "
    "ポケット ボタン バッグ "
    "パン チーズ バター ジャム ハム ソーセージ サラダ スープ ステーキ "
    "ハンバーガー ピザ パスタ サンドイッチ オムレツ プリン ゼリー "
    "ミルク コーラ ジュース ウイスキー カクテル "
    "スポーツ サッカー テニス ゴルフ スキー スケート ジョギング ダンス "
    "ピアノ ギター バイオリン ドラム コンサート オーケストラ バンド "
    "クラス グループ チーム クラブ サークル メンバー リーダー キャプテン "
    "アイデア イメージ デザイン スタイル ファッション ブランド モデル "
    "プレゼント カード アルバム ポスター カレンダー ペン ノート "
    "エネルギー パワー スピード バランス チャンス ポイント ルール テーマ "
    "レベル クイズ テスト レポート プロジェクト スケジュール プラン", _MID)

# -- tech compounds -----------------------------------------------------------
_add(JAPANESE_LEXICON,
    "人工知能 機械学習 深層学習 自然言語 音声認識 画像認識 "
    "半導体 集積回路 自動運転 電気自動車 太陽光発電", _LOW)

# -- broad katakana loanword band ----------------------------------------
# General-purpose loanword vocabulary: everyday/business/tech/sports/food
# katakana plus common Western given and family names.  The role of
# IPADIC's wide loanword coverage in kuromoji: unknown-compound splitting
# is only possible when the lattice KNOWS the constituent words.
_add(JAPANESE_LEXICON,
    "センター ビジネス オフィスビル サラリーマン キャリア スタッフ "
    "アルバイト パート マネジメント リーダーシップ トレーニング "
    "ミーティング プレゼン プレゼンテーション ワークショップ セミナー "
    "イベント キャンペーン セール ショッピング ショップ ストア マーケット "
    "モール デパート スーパーマーケット コンビニエンスストア レジ "
    "カウンター メニュー ランチ ディナー モーニング ブレックファスト "
    "バイキング ビュッフェ テイクアウト デリバリー ファストフード "
    "ドリンク スイーツ デザートメニュー "
    "バンク モバイル ホールディング グループウェア システムズ "
    "ソフトバンク トヨタ ホンダ ニッサン パナソニック ソニー キヤノン "
    "ニコン シャープ トウシバ フジツウ ヒタチ ミツビシ スズキ マツダ "
    "ユニクロ ラクテン アマゾン グーグル アップル マイクロソフト "
    "フェイスブック ツイッター ユーチューブ インスタグラム ライン "
    "ヤフー ネットフリックス ディズニー スターバックス マクドナルド", _LOW)
_add(JAPANESE_LEXICON,
    "マイケル ジョン デイビッド デービッド ジェームズ ロバート ウィリアム "
    "リチャード トーマス チャールズ ダニエル ポール マーク ジョージ "
    "スティーブ スティーブン ケビン ブライアン エリック アンドリュー "
    "ピーター トニー クリス クリストファー アレックス サム ベン "
    "メアリー エリザベス ジェニファー リンダ サラ エミリー アンナ "
    "ジャクソン スミス ジョンソン ブラウン デイビス ミラー ウィルソン "
    "テイラー アンダーソン マーティン ジョーンズ ガルシア クラーク "
    "ルイス ウォーカー ヤング キング ライト ヒル グリーン アダムズ "
    "ネルソン ベイカー カーター ミッチェル ロバーツ ターナー フィリップス "
    "パーカー エバンス コリンズ モリス ロジャース クーパー ベル "
    "ジョブズ ゲイツ オバマ トランプ リンカーン ワシントン "
    "アインシュタイン ニュートン ダーウィン エジソン モーツァルト "
    "ベートーベン ピカソ ゴッホ シェイクスピア ヘミングウェイ", _LOW)
_add(JAPANESE_LEXICON,
    "オリンピック パラリンピック ワールドカップ チャンピオン トーナメント "
    "リーグ シーズン スタジアム グラウンド トラック フィールド "
    "バスケット バレー ラグビー ホッケー ボクシング レスリング "
    "フィギュア スノーボード サーフィン ボウリング バドミントン "
    "クリスマス ハロウィン バレンタイン イースター カーニバル "
    "フェスティバル パレード セレモニー アニバーサリー ウェディング "
    "マテリアル メタル プラスチック カーボン セラミック アルミニウム "
    "チタン シリコン ポリマー ナイロン ポリエステル ビニール ゴム "
    "コンクリート アスファルト ガソリン ディーゼル エンジン モーター "
    "バッテリー ソーラー タービン ポンプ バルブ センサー チップ "
    "プロセッサ メモリ ストレージ ディスプレイ モニター キーボード "
    "マウス プリンター スキャナー ルーター モデム ケーブル コネクタ "
    "アダプター チャージャー イヤホン ヘッドホン スピーカー マイク "
    "ステレオ アンプ チューナー リモコン バックアップ インストール "
    "アップデート アップグレード ログイン ログアウト パスワード "
    "アカウント プロフィール メッセージ チャット コメント フォロー "
    "シェア ブログ ポッドキャスト ストリーミング", _LOW)

# -- business/tech loanwords + institutional Sino-Japanese vocabulary --------
# common decompounding units (katakana compounds split at word boundaries,
# the kuromoji search-mode behavior measured by cjk_gold_ja_kuromoji.txt)
_add(JAPANESE_LEXICON,
    "エンジニア エンジニアリング ソフトウェア ハードウェア ミドルウェア "
    "ホールディングス コーポレーション テクノロジー マネジャー "
    "マネージャー プロジェクト サービス ソリューション コンサルティング "
    "インダストリー プロダクツ ファクトリー セールス マーケティング "
    "シニア ジュニア アーキテクト アドミニストレーター モバイル "
    "グローバル ネットワーク セキュリティ クラウド プラットフォーム "
    "パートナー ディレクター オフィス センター リサーチ ラボ "
    "プロテイン バイオ メディカル ファイナンス キャピタル", _LOW)
_add(JAPANESE_LEXICON,
    "国際 先端 空港 大学 大学院 経済 政府 企業 会社 社会 情報 技術 開発 "
    "研究 研究所 環境 教育 委員会 産業 金融 市場 製品 管理 計画 戦略 "
    "部門 地域 世界 全国 公式 発表 発展 協力 組織 制度 状況 活動 対応 "
    "野球 硬式 文学 科学 歴史 芸術 音楽 美術 医学 工学 法学", _LOW)


# -- corpus-derived data tiers -------------------------------------------
# The curated bands above are the hand-checked core; the bundled TSVs add
# corpus-derived depth:
#   data/zh_ansj.tsv   — 38k Chinese words, ln-freqs from the ansj_seg core
#                        dictionary counts (Apache-2.0).
#   data/ja_ipadic.tsv — 5.5k Japanese surface forms, ln-freqs learned from
#                        the IPADIC-tokenized 'Botchan' train split
#                        (kuromoji test corpus, Apache-2.0); the held-out
#                        split is the independent gold fixture.
# Max-merge keeps the higher score when a word is in both tiers, so the
# curated core cannot be downgraded by sparse corpus counts.  Derivation:
# tools/build_cjk_lexicons.py.
def _iter_data_rows(name: str):
    """Tab-split rows of a bundled data TSV; yields nothing when the file
    is absent (packaged data missing: the curated cores alone still
    provide the capability)."""
    import os
    path = os.path.join(os.path.dirname(__file__), "data", name)
    if not os.path.exists(path):
        return
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                yield parts


def _load_tsv(lex: Dict[str, float], name: str) -> None:
    for parts in _iter_data_rows(name):
        word, score = parts[0], parts[-1]
        prev = lex.get(word)
        s = float(score)
        # max-merge, same rule as _add: a data tier must not downgrade a
        # curated-core score
        lex[word] = s if prev is None else max(prev, s)


_load_tsv(CHINESE_LEXICON, "zh_ansj.tsv")
_load_tsv(JAPANESE_LEXICON, "ja_ipadic.tsv")

# Japanese bigram transition bonuses (the ansj NgramLibrary /
# kuromoji ViterbiSearcher transition-cost role): (w1, w2) -> positive PMI
# learned from the same Botchan train split as the unigram tier; "<s>" is
# the run-initial pseudo-word.  data/ja_bigram.tsv, derivation in
# tools/build_cjk_lexicons.py build_ja_bigrams.
JAPANESE_BIGRAMS: Dict[tuple, float] = {}


def _load_bigrams(table: Dict[tuple, float], name: str) -> None:
    for parts in _iter_data_rows(name):
        if len(parts) == 3:
            table[(parts[0], parts[1])] = float(parts[2])


_load_bigrams(JAPANESE_BIGRAMS, "ja_bigram.tsv")


# ============================================================== Korean ======
# The reference wraps KOMORAN/open-korean-text jars
# (deeplearning4j-nlp-korean/.../KoreanTokenizerFactory.java) and bundles no
# dictionary data, so this lexicon is a curated core (no corpus source
# exists in the reference to derive from — the module is
# two .java wrappers, zero data files).  Granularity follows the
# reference's own KoreanTokenizerTest gold: nouns whole (오픈소스,
# 라이브러리), compound loanwords split at word boundaries (딥|러닝),
# copula split 입니|다.  The in-module bands below are the hand-checked
# function-word core; data/ko_curated.tsv (~1.8k entries,
# build_ko in tools/build_cjk_lexicons.py) adds curated vocabulary depth
# in the same frequency bands.
KOREAN_LEXICON: Dict[str, float] = {}

# particles (josa)
_add(KOREAN_LEXICON,
    "은 는 이 가 을 를 의 에 에서 으로 로 와 과 도 만 께서 까지 부터 "
    "처럼 보다 하고 이나 나 랑 이랑 에게 한테 께 마다 조차 밖에 처럼", _TOP)
# verbal endings / copula units
_add(KOREAN_LEXICON,
    "입니 습니 합니 됩니 갑니 옵니 다 요 고 며 지만 는데 면 려고 게 기 "
    "지 죠 네 군요 거든요 세요 하세요", _TOP)
_add(KOREAN_LEXICON,
    "하 되 있 없 간 온 볼 준 받 했 됐 있었 없었 한 할 하는 하고 해서 "
    "하면 하여 되는 되어 있는 있어 없는", _HIGH)
# common nouns / loanwords
_add(KOREAN_LEXICON,
    "세계 최초 상용 수준 오픈소스 딥 러닝 라이브러리 소프트웨어 하드웨어 "
    "컴퓨터 인공지능 기계학습 데이터 모델 알고리즘 프로그램 시스템 "
    "네트워크 인터넷 서버 클라우드 코드 언어 처리 자연어 기술 과학 "
    "개발 연구 공부 학습 분석 설계 구현 실험 결과 성능 속도 문제 해결", _HIGH)
_add(KOREAN_LEXICON,
    "학교 학생 선생님 교수 회사 직원 사람 친구 가족 부모 아이 남자 여자 "
    "시간 오늘 내일 어제 아침 점심 저녁 밤 주말 올해 작년 내년 지금 "
    "한국 서울 부산 나라 도시 지역 정부 시장 경제 사회 문화 역사 교육 "
    "음악 영화 사진 여행 운동 축구 야구 음식 커피 우유 "
    "집 방 문 창문 책 책상 의자 전화 뉴스 신문 은행 병원 공항 역 "
    "기차 버스 비행기 자동차 지하철 길 공원 산 바다 강 하늘 날씨 비 눈", _MID)
_add(KOREAN_LEXICON,
    "생각 사랑 마음 이야기 질문 대답 도움 시작 끝 계획 약속 회의 발표 "
    "수도 도서관 과일 중요 많이 "
    "보고서 제품 서비스 가격 판매 구매 사용 이용 준비 연습 시험 성적 "
    "여름 겨울 봄 가을 생일 선물 축하 감사 행복 건강 안전 자유 평화", _MID)

_load_tsv(KOREAN_LEXICON, "ko_curated.tsv")
